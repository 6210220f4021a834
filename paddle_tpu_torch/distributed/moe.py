"""Mixture-of-Experts with expert parallelism over the 'ep' mesh axis
(port of paddle_tpu/distributed/moe.py; GShard arxiv 2006.16668, Switch
arxiv 2101.03961).

`MoEMLP` keeps the JAX layer's parameters, shapes and initialisers:
router [H, E] (f32 routing), stacked experts w_up [E, H, F], b_up
[E, F], w_down [E, F, H], b_down [E, H]; `aux_loss` holds the Switch
load-balance loss of the last forward.

Routing is the JAX package's: top-k passes of argmax over the gates,
each token's queue position in its expert from a cumsum over the tokens
chained across the k passes, the keep rule pos < C with
C = max(min_capacity, ceil(k * S / E * capacity_factor)), the combine
weights renormalised by the selected gates' mass when k > 1, and
aux = E * sum_e(fraction routed to e first * mean gate of e).

The JAX layer builds that routing as dense one-hot dispatch and combine
tensors [S, E, C] and contracts them with einsums. At the bench GPT's
width (S = 32 x 1024 tokens, E = 8, C = 10240) each holds 2.7e9
elements, 10.7 GB in f32, per MoE layer, so the port computes the same
routing as slot indices (`_route`): the kept (token, pass) pairs scatter
their tokens into an [E, C', H] buffer at expert e, slot c; the experts
run as torch.bmm over the stacked weights (the JAX package computes
these products outside any Pallas kernel); the outputs are gathered
back from the same slots and summed into the tokens with their combine
weights. The gathers' gradients are index_adds: with top-2 routing a
token's two contributions sum to the same value in either order, so the
step stays deterministic (top-k > 2 sums in the order the atomics land).
`moe_dispatch_combine` builds the dense tensors (the JAX API's), and
`_moe_dense` computes the layer from them: the plain twin the tests and
chip_smoke.py hold the indexed form to.

Across ranks the routing is the JAX step's over the GLOBAL batch (GSPMD
routes the whole batch as one array): S, C, the queue positions and
the aux means are those of every token of the batch. The ranks that
hold the batch's other rows are the group of the mesh's `batch_axes`
(ShardedTrainStep sets them to its batch_spec; rank r holds the r-th
block of rows). Each pass all-gathers the ranks' counts per expert, so
a token's position is its place among the earlier ranks' tokens of its
expert, then its own rank's; the aux means are all-reduced sums, whose
backward is the same all-reduce, so that the ranks' mean of gradients
(ShardedTrainStep's) is the gradient of the global aux. A rank buffers
only its own kept pairs: the pairs of one expert that a rank keeps are
the first of its pairs in (pass, token) order, so each takes slot c,
its place among them, in a buffer of C' = min(C, S_local) slots (a
token picks an expert at most once). `dropped` counts this rank's
dropped pairs.

With ep > 1 each rank holds E/ep experts (w_up etc. are split on dim 0
over 'ep'), and the [E, C', H] buffer moves to the experts' ranks and
back by all_to_all_single (dp -> ep and ep -> dp), whose backward is the
reverse all-to-all. ShardedTrainStep divides the experts' gradients by
the ep size (see parallel/api.py).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as TF

from ..parallel.api import P, mark_sharding  # noqa: I001 (P before M)
from ..core.tensor import plain_dispatch
from ..ops import manipulation as M
from ..nn.layer.layers import Layer
from ..parallel import mesh as _mesh

__all__ = ["P", "M", "moe_dispatch_combine", "MoEMLP"]


def moe_dispatch_combine(gates, top_k: int, capacity: int):
    """Dense one-hot routing tensors from softmax gates (the JAX
    package's form). gates [S, E] f32 -> (dispatch [S, E, C], combine
    [S, E, C], aux scalar): combine[s, e, c] is the weight with which
    token s's copy in expert e's slot c folds back, dispatch its 0/1
    support, aux the Switch load-balance loss (1 at perfect balance)."""
    S, E = gates.shape
    g = gates
    combine = gates.new_zeros(S, E, capacity)
    offset = gates.new_zeros(1, E)
    denom = gates.new_zeros(S)
    first_mask = None
    for _ in range(top_k):
        m = TF.one_hot(torch.argmax(g, dim=-1), E).to(gates.dtype)
        if first_mask is None:
            first_mask = m
        gate_val = torch.sum(gates * m, dim=-1)
        denom = denom + gate_val
        pos = torch.cumsum(m, dim=0) - 1.0 + offset
        pos_tok = torch.sum(pos * m, dim=-1)
        keep = (pos_tok < capacity).to(gates.dtype)
        slot = TF.one_hot(pos_tok.long().clamp(max=capacity),
                          capacity + 1)[:, :capacity].to(gates.dtype)
        ce = m * (gate_val * keep)[:, None]
        combine = combine + ce[:, :, None] * slot[:, None, :]
        offset = offset + torch.sum(m, dim=0, keepdim=True)
        g = g * (1.0 - m)
    if top_k > 1:
        combine = combine / torch.clamp(denom, min=1e-9)[:, None, None]
    disp = (combine > 0.0).to(gates.dtype)
    aux = E * torch.sum(torch.mean(first_mask, dim=0)
                        * torch.mean(gates, dim=0))
    return disp, combine, aux


def _route(gates, top_k: int, capacity: int, group=None):
    """The routing of moe_dispatch_combine as slot indices over every
    (token, pass) pair, passes in order: (token [kS], slot e * C' + c
    [kS], weight [kS], dropped pairs, aux), C' = min(capacity, S). A
    dropped pair (global position >= capacity) gets the spare slot
    E * C', which no expert reads, and weight 0: the sizes are fixed, so
    routing never waits on the host. `group` is (process group, ranks,
    this rank's index) of the ranks holding the batch's other rows, or
    None (module docstring)."""
    S, E = gates.shape
    pg, n, me = group or (None, 1, 0)
    width = min(capacity, S)
    g = gates
    offset = gates.new_zeros(E)   # every rank's pairs of earlier passes
    local = gates.new_zeros(E)    # this rank's pairs of earlier passes
    denom = gates.new_zeros(S)
    picks = []
    first = None
    for _ in range(top_k):
        idx = torch.argmax(g, dim=-1)
        m = TF.one_hot(idx, E).to(gates.dtype)
        if first is None:
            first = m
        gate_val = torch.gather(gates, 1, idx[:, None]).squeeze(1)
        denom = denom + gate_val
        # each token's queue position in its expert: the running count
        # of its expert's tokens, scanned along the tokens as the inner
        # dim of [E, S] (a scan over the outer dim of [S, E] runs E-wide
        # and took 5 ms a call at S 32768 on the H100)
        count = torch.cumsum(m.t().contiguous(), dim=1)
        mine = count[:, -1]
        before, total = _rank_counts(mine, pg, n, me)
        within = torch.gather(count, 0, idx[None]).squeeze(0) - 1.0
        picks.append((idx, within + (offset + before)[idx],
                      within + local[idx], gate_val))
        offset = offset + total
        local = local + mine
        g = g * (1.0 - m)
    slots, weights, kept = [], [], []
    for idx, pos, lpos, gate_val in picks:
        keep = pos < capacity
        w = gate_val / torch.clamp(denom, min=1e-9) if top_k > 1 \
            else gate_val
        slots.append(torch.where(keep, idx * width + lpos.long(),
                                 E * width))
        weights.append(w * keep.to(w.dtype))
        kept.append(keep)
    tokens = torch.arange(S, device=gates.device).repeat(top_k)
    dropped = top_k * S - torch.count_nonzero(torch.cat(kept))
    frac, mean_gate = first.sum(0), gates.sum(0)
    if pg is not None:
        from . import collective as C
        C._all_reduce(frac, C.ReduceOp.SUM, pg)
        # summed forward and backward: each rank's aux reads every
        # rank's gates, so each rank's gradient sums every rank's
        from .tp_layers import _CopyToTP, _ReduceFromTP
        mean_gate = _ReduceFromTP.apply(_CopyToTP.apply(mean_gate, pg), pg)
    aux = E * torch.sum((frac / (n * S)) * (mean_gate / (n * S)))
    return tokens, torch.cat(slots), torch.cat(weights), dropped, aux


def _rank_counts(mine, pg, n, me):
    """(pairs per expert on the ranks before this one, on every rank)
    from each rank's `mine` [E]: one all-gather over `pg`."""
    if pg is None:
        return torch.zeros_like(mine), mine
    from . import collective as C
    every = C._all_gather(mine.new_empty(n, mine.shape[0]), mine, pg)
    return every[:me].sum(0), every.sum(0)


class _AllToAll(torch.autograd.Function):
    """x [ep, ...] exchanged over the ep group (row r to rank r); the
    backward exchanges the gradient back."""

    @staticmethod
    def forward(ctx, x, pg):
        from . import collective as C
        ctx.pg = pg
        x = x.contiguous()
        return C._all_to_all(torch.empty_like(x), x, pg)

    @staticmethod
    def backward(ctx, g):
        from . import collective as C
        g = g.contiguous()
        return C._all_to_all(torch.empty_like(g), g, ctx.pg), None


def _experts(xe, wu, bu, wd, bd):
    """[E, C, H] tokens through the stacked expert FFNs."""
    h = torch.bmm(xe, wu.to(xe.dtype)) + bu.to(xe.dtype)[:, None, :]
    h = TF.gelu(h, approximate="tanh")
    return torch.bmm(h, wd.to(h.dtype)) + bd.to(h.dtype)[:, None, :]


def _capacity(S, E, top_k, capacity_factor, min_capacity):
    return max(int(min_capacity),
               int(math.ceil(top_k * S / E * capacity_factor)))


def _gates(x2, wr):
    return torch.softmax(x2.float() @ wr.float(), dim=-1)


@plain_dispatch
def _moe_indexed(x, wr, wu, bu, wd, bd, top_k, capacity_factor,
                 min_capacity, ep_group=None, ep=1, group=None):
    """x [B, T, H] -> (out [B, T, H], aux, dropped pairs): the layer over
    slot indices (module docstring); wu..bd hold this rank's E / ep
    experts; `group` as _route's."""
    B, T, H = x.shape
    S = B * T
    E = wr.shape[1]
    x2 = x.reshape(S, H)
    gates = _gates(x2, wr)
    n = group[1] if group else 1
    C = _capacity(n * S, E, top_k, capacity_factor, min_capacity)
    tok, slot, w, dropped, aux = _route(gates, top_k, C, group)
    C = min(C, S)   # the slots of this rank's buffer (_route's C')
    # index_select (not x2[tok]): its backward is an index_add, where
    # advanced indexing's sorts the indices first
    buf = x2.new_zeros(E * C + 1, H).index_copy(
        0, slot, torch.index_select(x2, 0, tok))[:E * C]
    if ep > 1:
        # [ep, E/ep, C, H]: row r to the rank holding experts r*E/ep..
        got = _AllToAll.apply(buf.view(ep, E // ep, C, H), ep_group)
        xe = got.transpose(0, 1).reshape(E // ep, ep * C, H)
        ye = _experts(xe, wu, bu, wd, bd)
        back = ye.reshape(E // ep, ep, C, H).transpose(0, 1)
        out_e = _AllToAll.apply(back, ep_group).reshape(E * C, H)
    else:
        out_e = _experts(buf.view(E, C, H), wu, bu, wd, bd).view(E * C, H)
    out_e = torch.cat([out_e, out_e.new_zeros(1, H)])  # the spare slot
    y = torch.index_select(out_e, 0, slot) * w.to(out_e.dtype)[:, None]
    out = x2.new_zeros(S, H, dtype=y.dtype).index_add(0, tok, y)
    return out.reshape(B, T, H).to(x.dtype), aux.float(), dropped


@plain_dispatch
def _moe_dense(x, wr, wu, bu, wd, bd, top_k, capacity_factor,
               min_capacity):
    """The JAX package's dense einsum form (paddle_tpu/distributed/
    moe.py:127-157): the plain twin of _moe_indexed at ep 1."""
    B, T, H = x.shape
    S = B * T
    E = wr.shape[1]
    x2 = x.reshape(S, H)
    gates = _gates(x2, wr)
    C = _capacity(S, E, top_k, capacity_factor, min_capacity)
    disp, combine, aux = moe_dispatch_combine(gates, top_k, C)
    ein = torch.einsum("sec,sh->ech", disp.to(x.dtype), x2)
    out_e = _experts(ein, wu, bu, wd, bd)
    out = torch.einsum("sec,ech->sh", combine.to(out_e.dtype), out_e)
    dropped = top_k * S - torch.count_nonzero(disp)
    return out.reshape(B, T, H).to(x.dtype), aux.float(), dropped


def _batch_group(mesh):
    """(process group, ranks, this rank's index) of the ranks holding the
    batch's other rows under `mesh`, or None (no process group, or this
    rank holds the whole batch)."""
    if mesh is None:
        return None
    pg = mesh.group(mesh.batch_axes)
    if pg is None:
        return None
    return pg, mesh.axis_size(mesh.batch_axes), mesh.coord(mesh.batch_axes)


class MoEMLP(Layer):
    """Expert-parallel FFN, a drop-in for a dense transformer MLP. After
    forward, `aux_loss` holds the load-balance loss for the caller's
    objective (weight it, e.g. 0.01, and add it to the task loss in the
    same forward, as models/gpt.py GPT.loss does)."""

    def __init__(self, hidden_size: int, num_experts: int,
                 ffn_hidden_size: int = None, top_k: int = 2,
                 capacity_factor: float = 1.25, min_capacity: int = 4,
                 name=None):
        super().__init__()
        if num_experts < 1:
            raise ValueError("num_experts must be >= 1")
        from ..nn import initializer as I
        from .tp_layers import _sliced
        ffn = ffn_hidden_size or 4 * hidden_size
        self.num_experts = num_experts
        self.top_k = min(top_k, num_experts)
        self.capacity_factor = float(capacity_factor)
        self.min_capacity = int(min_capacity)
        m = _mesh.get_global_mesh()
        self._ep = m.shape["ep"] if m is not None else 1
        if num_experts % self._ep:
            raise ValueError(f"{num_experts} experts do not split over "
                             f"ep={self._ep}")
        self.router = self.create_parameter(
            [hidden_size, num_experts],
            default_initializer=I.Normal(0.0, 0.02))
        mark_sharding(self.router)
        self.w_up = _sliced(self.create_parameter(
            [num_experts, hidden_size, ffn],
            default_initializer=I.Normal(0.0, 0.02)), ("ep", None, None))
        self.b_up = _sliced(self.create_parameter(
            [num_experts, ffn], is_bias=True), ("ep", None))
        self.w_down = _sliced(self.create_parameter(
            [num_experts, ffn, hidden_size],
            default_initializer=I.Normal(0.0, 0.02)), ("ep", None, None))
        self.b_down = _sliced(self.create_parameter(
            [num_experts, hidden_size], is_bias=True), ("ep", None))
        self.aux_loss = None
        self.dropped = None   # (token, pass) pairs over capacity, a tensor

    def forward(self, x):
        squeeze = x.ndim == 2                  # [T, H] -> [1, T, H]
        if squeeze:
            x = x.unsqueeze(0)
        m = _mesh.get_global_mesh()
        pg = m.group("ep") if self._ep > 1 else None
        out, aux, self.dropped = _moe_indexed(
            x, self.router, self.w_up, self.b_up, self.w_down, self.b_down,
            self.top_k, self.capacity_factor, self.min_capacity, pg,
            self._ep, _batch_group(m))
        self.aux_loss = aux
        return out.squeeze(0) if squeeze else out
