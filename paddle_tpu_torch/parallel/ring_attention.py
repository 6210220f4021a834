"""Ring and Ulysses attention: context parallelism for long sequences
(port of paddle_tpu/parallel/ring_attention.py).

Both take this rank's chunk of the sequence, heads-major [B, H, T/n, D],
where n is the size of the mesh axis `axis_name` and the chunk's index
is the rank's coordinate along it, and return this rank's chunk of the
output. The JAX package runs them inside shard_map; here each rank is a
process and the axis's process group carries the traffic.

Ring (`ring_attention`). Q stays on its rank; K/V rotate one hop a step
to rank + 1 of the group (one batch of isend/irecv, the JAX package's
ppermute), so after s hops rank i holds chunk (i - s) mod n. A rank
attends in full to earlier chunks, causally to its own and not at all to
later ones, which it skips without a launch. Each hop's block is one
forward of kernel K1 (`flash_attention_fwd`: the block's output and row
logsumexp); the hops merge in f32 by their logsumexps (`merge`), with
rows that no hop reached yet guarded as the JAX package guards `safe_l`.
The backward is written out (the JAX package gets it from autodiff of
ppermute): it runs the ring again, each hop one K1 backward given the
merged output and the row's final logsumexp, so a block's P is its share
of the whole row; dq accumulates in f32 on its rank and dk/dv accumulate
in f32 beside their chunk, travelling with it, home after n hops.

`ring_chunks` and `ring_chunks_bwd` run the same hops over a list of
chunks in one process (every rank's work in the ring's order, the dk/dv
sums in the order they reach their chunk): the card's one-process check
of the ring, and the tests' twin of the distributed run.

Ulysses (`ulysses_attention`). One all-to-all re-shards q, k and v from
[B, H, T/n, D] to [B, H/n, T, D] (heads scatter, the sequence gathers),
full attention over the local heads runs through K1, and a second
all-to-all restores the layout; their backward is the inverse
all-to-all. H must divide by n, as in the JAX package.

On CUDA every block goes through K1, which takes T/n and head dims in
its scope (`flash_attention.supported`) and raises otherwise; on the CPU
the wrappers run their plain versions, hop by hop. `shard_map`, the JAX
package's version shim that these functions are used under there, has
no counterpart: a rank here is a process.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch

from ..ops.kernels.flash_attention import (flash_attention,
                                           flash_attention_bwd,
                                           flash_attention_fwd)
from . import mesh as _mesh

__all__ = ["ring_attention", "ulysses_attention", "ring_chunks",
           "ring_chunks_bwd", "merge"]


def _axis(axis_name: str):
    """(process group or None, ring size, this rank's index) of the
    global mesh's axis `axis_name` (a ring of one without a mesh)."""
    mesh = _mesh.get_global_mesh()
    if mesh is None:
        return None, 1, 0
    return mesh.group(axis_name), mesh.shape[axis_name], \
        mesh.coord(axis_name)


def _relation(i: int, j: int, causal: bool) -> Optional[bool]:
    """How rank i's queries see chunk j: None (skipped: a later chunk
    under the causal mask), True (causally: its own chunk) or False (in
    full)."""
    if not causal:
        return False
    if j > i:
        return None
    return j == i


def merge(acc, o, lse):
    """Merge a block's (o, lse) into the running (o f32, lse f32) of the
    row (None before the first block) by their logsumexps."""
    o = o.float()
    if acc is None:
        return o, lse
    o_acc, l_acc = acc
    l_new = torch.logaddexp(l_acc, lse)
    # a row no block has reached has lse -inf on both sides
    safe = torch.where(torch.isfinite(l_new), l_new,
                       torch.zeros_like(l_new))
    a = torch.exp(l_acc - safe)[..., None]
    b = torch.exp(lse - safe)[..., None]
    return o_acc * a + o * b, l_new


def _fwd_hop(q, i, j, k, v, acc, causal, scale):
    rel = _relation(i, j, causal)
    if rel is None:
        return acc
    o, lse = flash_attention_fwd(q, k, v, rel, scale)
    return merge(acc, o, lse)


def _bwd_hop(q, i, j, k, v, o, lse, do, causal, scale):
    """(dq, dk, dv) of rank i's block against chunk j, or None."""
    rel = _relation(i, j, causal)
    if rel is None:
        return None
    return flash_attention_bwd(q, k, v, o, lse, do, rel, scale)


def _finish(acc, q):
    o, lse = acc
    return o.to(q.dtype), lse.contiguous()


def _rotate(tensors: List[torch.Tensor], pg, n: int, i: int):
    """Every rank sends `tensors` to rank i + 1 and receives rank
    i - 1's (one batch of point-to-point ops)."""
    from ..distributed import collective as C
    recvs = [torch.empty_like(t) for t in tensors]
    C._send_recv(tensors, (i + 1) % n, recvs, (i - 1) % n, pg)
    return recvs


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, pg, n, i, causal, scale):
        acc = None
        kv = torch.stack([k, v])
        for s in range(n):
            acc = _fwd_hop(q, i, (i - s) % n, kv[0], kv[1], acc, causal,
                           scale)
            if s < n - 1:
                kv = _rotate([kv], pg, n, i)[0]
        o, lse = _finish(acc, q)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.ring = (pg, n, i, causal, scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        pg, n, i, causal, scale = ctx.ring
        do = do.contiguous()
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        kv = torch.stack([k, v])
        dkv = torch.zeros(kv.shape, dtype=torch.float32, device=q.device)
        for s in range(n):
            g = _bwd_hop(q, i, (i - s) % n, kv[0], kv[1], o, lse, do,
                         causal, scale)
            if g is not None:
                dq += g[0].float()
                dkv[0] += g[1].float()
                dkv[1] += g[2].float()
            # dk/dv ride with their chunk; the n-th hop takes them home
            if s < n - 1:
                kv, dkv = _rotate([kv, dkv], pg, n, i)
            elif n > 1:
                dkv = _rotate([dkv], pg, n, i)[0]
        return (dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype),
                None, None, None, None, None)


def ring_attention(q, k, v, axis_name: str, causal: bool = True,
                   scale: Optional[float] = None):
    """Blockwise ring attention over the mesh axis `axis_name`.

    q, k, v: [B, H, T_local, D], this rank's sequence chunk (chunk index
    = its coordinate along the axis). Returns [B, H, T_local, D] in q's
    dtype. Differentiable (the backward runs the ring again)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    pg, n, i = _axis(axis_name)
    return _Ring.apply(q, k, v, pg, n, i, bool(causal), float(scale))


def ring_chunks(qs: Sequence[torch.Tensor], ks: Sequence[torch.Tensor],
                vs: Sequence[torch.Tensor], causal: bool = True,
                scale: Optional[float] = None
                ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """The ring's forward over n chunks in one process: ([o_i], [lse_i])
    as rank i of the distributed ring computes them, hop by hop."""
    n = len(qs)
    if scale is None:
        scale = 1.0 / math.sqrt(qs[0].shape[-1])
    outs, lses = [], []
    for i in range(n):
        acc = None
        for s in range(n):
            j = (i - s) % n
            acc = _fwd_hop(qs[i], i, j, ks[j], vs[j], acc, causal, scale)
        o, lse = _finish(acc, qs[i])
        outs.append(o)
        lses.append(lse)
    return outs, lses


def ring_chunks_bwd(qs, ks, vs, outs, lses, dos, causal: bool = True,
                    scale: Optional[float] = None):
    """The ring's backward over n chunks in one process: ([dq_i], [dk_j],
    [dv_j]), each dk/dv summed in f32 in the order the distributed ring
    brings the blocks to its chunk."""
    n = len(qs)
    if scale is None:
        scale = 1.0 / math.sqrt(qs[0].shape[-1])
    f32 = dict(dtype=torch.float32, device=qs[0].device)
    dq = [torch.zeros(q.shape, **f32) for q in qs]
    dk = [torch.zeros(k.shape, **f32) for k in ks]
    dv = [torch.zeros(v.shape, **f32) for v in vs]
    for s in range(n):
        for i in range(n):
            j = (i - s) % n
            g = _bwd_hop(qs[i], i, j, ks[j], vs[j], outs[i], lses[i],
                         dos[i], causal, scale)
            if g is not None:
                dq[i] += g[0].float()
                dk[j] += g[1].float()
                dv[j] += g[2].float()
    return ([a.to(q.dtype) for a, q in zip(dq, qs)],
            [a.to(k.dtype) for a, k in zip(dk, ks)],
            [a.to(v.dtype) for a, v in zip(dv, vs)])


# ---------------------------------------------------------------- Ulysses
def _a2a_in(x, pg, n):
    """[..., H, T/n, D] -> [..., H/n, T, D]: head group c goes to rank c,
    sequence chunks arrive in rank order."""
    from ..distributed import collective as C
    *lead, H, tl, D = x.shape
    send = x.reshape(*lead, n, H // n, tl, D).movedim(-4, 0).contiguous()
    recv = torch.empty_like(send)
    C._all_to_all(recv, send, pg)
    return recv.movedim(0, -3).reshape(*lead, H // n, n * tl, D)


def _a2a_out(x, pg, n):
    """[..., H/n, T, D] -> [..., H, T/n, D], _a2a_in's inverse."""
    from ..distributed import collective as C
    *lead, hl, T, D = x.shape
    send = x.reshape(*lead, hl, n, T // n, D).movedim(-3, 0).contiguous()
    recv = torch.empty_like(send)
    C._all_to_all(recv, send, pg)
    return recv.movedim(0, -4).reshape(*lead, n * hl, T // n, D)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pg, n, inverse):
        ctx.a2a = (pg, n, inverse)
        return (_a2a_out if inverse else _a2a_in)(x, pg, n)

    @staticmethod
    def backward(ctx, g):
        pg, n, inverse = ctx.a2a
        return (_a2a_in if inverse else _a2a_out)(g, pg, n), None, None, \
            None


def ulysses_attention(q, k, v, axis_name: str, causal: bool = True,
                      scale: Optional[float] = None):
    """All-to-all sequence parallelism over the mesh axis `axis_name`
    (see the module docstring); requires H % axis size == 0."""
    pg, n, _ = _axis(axis_name)
    if q.shape[1] % n:
        raise ValueError(
            f"ulysses_attention: heads {q.shape[1]} must divide by the "
            f"'{axis_name}' axis size {n} (use ring_attention otherwise)")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    qkv = torch.stack([q, k, v])
    if pg is not None:
        qkv = _AllToAll.apply(qkv, pg, n, False)
    out = flash_attention(qkv[0], qkv[1], qkv[2], causal=causal,
                          scale=scale, heads_major=True)
    if pg is not None:
        out = _AllToAll.apply(out, pg, n, True)
    return out
