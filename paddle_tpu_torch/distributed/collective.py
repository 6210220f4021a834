"""The collective API over torch.distributed (port of
paddle_tpu/distributed/collective.py).

A Group is one mesh axis (parallel/mesh.py): its process group is the
global mesh's group of this rank along that axis, or, with no mesh, the
world. The JAX package runs these ops inside a shard_map trace as lax
collectives, or between processes through host gathers; here every op
calls torch.distributed on the group's process group: NCCL on CUDA
tensors, gloo on CPU ones (init_parallel_env picks the backend).

- With no process group initialised and a world of one, the ops are
  the identity, as in the JAX package (a larger world without one
  raises: nothing runs quietly on one rank).
- With a process group initialised they call torch.distributed even
  when the group is the world of one rank, so a run on one GPU goes
  through NCCL.
- `send`/`recv` are torch.distributed's point-to-point ops (the JAX
  package's host socket channel, `_P2PChannel`, has no use here).
- `src`/`dst` are positions within the group (the JAX package's
  position along the axis), turned into global ranks for torch.
- The ops change `tensor` in place and return it (Paddle's semantics);
  the c_* aliases return a new tensor and leave their input as it was.
  None of them is differentiable (the tensor-parallel layers and MoE
  carry their own autograd Functions over the same primitives).

Each primitive that calls torch.distributed counts its calls in a plain
integer, `.calls` (`_all_reduce.calls`, `_reduce_scatter.calls`,
`_all_gather.calls`, ...), as the kernel wrappers count launches;
`collective_calls()` reads them all and `reset_collective_calls()` sets
them to 0.
"""
from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist

from ..core.tensor import box, plain
from ..parallel import mesh as _mesh

__all__ = ["ReduceOp", "Group", "new_group", "get_group", "all_reduce",
           "all_gather", "all_gather_object", "reduce_scatter", "broadcast",
           "reduce", "scatter", "alltoall", "barrier", "send", "recv",
           "get_world_size", "get_rank", "axis_index", "c_allreduce_sum",
           "c_allreduce_max", "c_allreduce_min", "c_allreduce_prod",
           "c_broadcast", "c_allgather", "c_reducescatter",
           "c_sync_calc_stream", "c_sync_comm_stream", "c_gen_nccl_id",
           "c_comm_init", "wait", "collective_calls",
           "reset_collective_calls"]


class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"
    AVG = "avg"


_TORCH_OPS = {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.MAX: dist.ReduceOp.MAX,
              ReduceOp.MIN: dist.ReduceOp.MIN,
              ReduceOp.PROD: dist.ReduceOp.PRODUCT,
              # gloo has no AVG: a sum, then a division by the group size
              ReduceOp.AVG: dist.ReduceOp.SUM}


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


class Group:
    """A process group: one mesh axis (reference: comm rings + groups in
    collective.py); `ranks` names an explicit group made by new_group."""

    def __init__(self, axis: str = "dp", ranks: Optional[List[int]] = None,
                 ring_id: int = 0):
        self.axis = axis
        self.ranks = ranks
        self.id = ring_id
        self._pg = None

    @property
    def process_group(self):
        """The torch process group, or None for a group of one (and for
        every group when no process group is initialised)."""
        if not _initialized():
            return None
        if self._pg is not None:
            return self._pg
        m = _mesh.get_global_mesh()
        if m is not None and self.ranks is None:
            return m.group(self.axis)
        return dist.group.WORLD

    @property
    def nranks(self):
        if self.ranks:
            return len(self.ranks)
        m = _mesh.get_global_mesh()
        if m is not None:
            return m.axis_size(self.axis)
        return _mesh.world_size()


_default_group = Group("dp", ring_id=0)
_groups = {0: _default_group}


def new_group(ranks=None, backend=None, axis: str = "dp"):
    """A group over `ranks` (every rank of the world must call it, as
    torch.distributed.new_group asks), or over the mesh axis `axis`."""
    gid = max(_groups) + 1
    g = Group(axis, list(ranks) if ranks else None, gid)
    if ranks and _initialized():
        pg = dist.new_group(list(ranks), backend=backend)
        g._pg = pg if dist.get_rank() in g.ranks else None
    _groups[gid] = g
    _mesh.register_ring(gid, axis)
    return g


def get_group(gid=0):
    return _groups.get(gid, _default_group)


def _resolve_group(group) -> Group:
    if group is None:
        return _default_group
    if isinstance(group, int):
        return get_group(group)
    return group


def _pg_of(group):
    """(process group, size) of a Group, ring id or None; (None, 1) is
    the identity. A world of several ranks with no process group
    raises."""
    g = _resolve_group(group)
    if not _initialized():
        if _mesh.world_size() > 1:
            raise RuntimeError(
                "collectives across ranks need init_parallel_env() (no "
                "torch.distributed process group is initialised)")
        return None, 1
    pg = g.process_group
    return pg, (1 if pg is None else dist.get_world_size(pg))


def _global(pg, rank_in_group: int) -> int:
    return dist.get_global_rank(pg, rank_in_group) \
        if pg is not dist.group.WORLD else rank_in_group


# ------------------------------------------------- counted primitives
def _counted(fn):
    fn.calls = 0
    return fn


@_counted
def _all_reduce(t, op, pg):
    _all_reduce.calls += 1
    dist.all_reduce(t, op=_TORCH_OPS[op], group=pg)
    if op == ReduceOp.AVG:
        t.div_(dist.get_world_size(pg))
    return t


@_counted
def _all_gather(out, t, pg):
    """out (n times t's elements, contiguous) <- every rank's t, in
    group order (flat views: gloo wants dim 0 to be n times t's)."""
    _all_gather.calls += 1
    dist.all_gather_into_tensor(out.view(-1), t.contiguous().view(-1),
                                group=pg)
    return out


@_counted
def _reduce_scatter(out, t, op, pg):
    """out (t's elements / n, contiguous) <- this rank's chunk of the
    reduced t, in flat order."""
    _reduce_scatter.calls += 1
    dist.reduce_scatter_tensor(out.view(-1), t.contiguous().view(-1),
                               op=_TORCH_OPS[op], group=pg)
    if op == ReduceOp.AVG:
        out.div_(dist.get_world_size(pg))
    return out


@_counted
def _broadcast(t, src, pg):
    _broadcast.calls += 1
    dist.broadcast(t, src=_global(pg, src), group=pg)
    return t


@_counted
def _all_to_all(out, t, pg, out_splits=None, in_splits=None):
    _all_to_all.calls += 1
    dist.all_to_all_single(out, t.contiguous(), out_splits, in_splits,
                           group=pg)
    return out


@_counted
def _scatter(t, parts, src, pg):
    _scatter.calls += 1
    me = dist.get_rank(pg)
    dist.scatter(t, [p.contiguous() for p in parts] if me == src else None,
                 src=_global(pg, src), group=pg)
    return t


@_counted
def _gather_object(objs, obj, pg):
    _gather_object.calls += 1
    out = [None] * dist.get_world_size(pg)
    dist.all_gather_object(out, obj, group=pg)
    objs.extend(out)
    return objs


@_counted
def _barrier(pg):
    _barrier.calls += 1
    dist.barrier(group=pg)


@_counted
def _send(t, dst, pg):
    _send.calls += 1
    dist.send(t.contiguous(), dst=_global(pg, dst), group=pg)


@_counted
def _recv(t, src, pg):
    _recv.calls += 1
    dist.recv(t, src=_global(pg, src), group=pg)
    return t


@_counted
def _send_recv(sends, dst, recvs, src, pg):
    """Send each tensor of `sends` to group position `dst` while
    receiving `recvs` from `src`, in one batch of point-to-point ops
    (a ring's rotation: every rank sends and receives at once)."""
    _send_recv.calls += 1
    ops = [dist.P2POp(dist.isend, t.contiguous(), _global(pg, dst), pg)
           for t in sends]
    ops += [dist.P2POp(dist.irecv, t, _global(pg, src), pg) for t in recvs]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recvs


_PRIMITIVES = (_all_reduce, _all_gather, _reduce_scatter, _broadcast,
               _all_to_all, _scatter, _gather_object, _barrier, _send, _recv,
               _send_recv)


def collective_calls() -> dict:
    """{primitive: calls since the last reset}."""
    return {f.__name__.lstrip("_"): f.calls for f in _PRIMITIVES}


def reset_collective_calls() -> None:
    for f in _PRIMITIVES:
        f.calls = 0


# ---------------------------------------------------------- public api
def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True,
               use_calc_stream=True):
    """paddle.distributed.all_reduce (reference: collective.py:157):
    in place on `tensor`, which it returns."""
    pg, n = _pg_of(group)
    if pg is not None:
        _all_reduce(plain(tensor).data, op, pg)
    return tensor


def all_gather(tensor_list, tensor, group=None, sync_op=True):
    """reference: collective.py:313: appends every rank's `tensor` to
    tensor_list, in group order."""
    pg, n = _pg_of(group)
    if pg is None:
        tensor_list.append(tensor)
        return tensor_list
    t = plain(tensor).detach()
    out = torch.empty((n,) + tuple(t.shape), dtype=t.dtype, device=t.device)
    _all_gather(out, t[None], pg)
    tensor_list.extend(box(p) for p in out.unbind(0))
    return tensor_list


def all_gather_object(obj_list, obj, group=None):
    """Every rank's picklable `obj`, appended to obj_list in group
    order."""
    pg, _ = _pg_of(group)
    if pg is None:
        obj_list.append(obj)
        return obj_list
    return _gather_object(obj_list, obj, pg)


def reduce_scatter(tensor, tensor_or_list, op=ReduceOp.SUM, group=None):
    """`tensor` <- this rank's chunk (dim 0) of the reduction of every
    rank's `tensor_or_list` (a list is concatenated on dim 0 first)."""
    src = tensor_or_list
    if isinstance(src, (list, tuple)):
        src = torch.cat([plain(s) for s in src], dim=0)
    src = plain(src).detach()
    pg, n = _pg_of(group)
    dst = plain(tensor).data
    if pg is None:
        dst.copy_(src)
        return tensor
    _reduce_scatter(dst, src, op, pg)
    return tensor


def broadcast(tensor, src=0, group=None, sync_op=True):
    """reference: collective.py:101: `tensor` <- the group's rank
    `src`'s."""
    pg, _ = _pg_of(group)
    if pg is not None:
        _broadcast(plain(tensor).data, src, pg)
    return tensor


def reduce(tensor, dst=0, op=ReduceOp.SUM, group=None, sync_op=True):
    """The reduction lands on every rank (so on `dst`), as in the JAX
    package."""
    return all_reduce(tensor, op, group)


def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True):
    """`tensor` <- tensor_list[rank] of the group's rank `src` (only src
    needs to pass tensor_list)."""
    pg, _ = _pg_of(group)
    if pg is None:
        if tensor_list:
            plain(tensor).data.copy_(plain(tensor_list[src]))
        return tensor
    _scatter(plain(tensor).data, [plain(t) for t in tensor_list or []],
             src, pg)
    return tensor


def alltoall(in_tensor_list, out_tensor_list, group=None, sync_op=True):
    """Rank r's in_tensor_list[s] becomes rank s's out_tensor_list[r]."""
    pg, n = _pg_of(group)
    if pg is None:
        out_tensor_list.extend(in_tensor_list)
        return out_tensor_list
    ins = [plain(t).detach() for t in in_tensor_list]
    x = torch.cat([t.reshape(-1) for t in ins])
    out = torch.empty_like(x)
    _all_to_all(out, x, pg)
    out_tensor_list.extend(box(p.reshape(ins[0].shape))
                           for p in out.chunk(n))
    return out_tensor_list


def barrier(group=None):
    """reference: collective.py:457: every rank of the group reaches this
    point before any goes on."""
    pg, _ = _pg_of(group)
    if pg is not None:
        _barrier(pg)


def send(tensor, dst=0, group=None, sync_op=True):
    """reference: send_v2_op.cc: `tensor` to the group's rank `dst`."""
    pg, n = _pg_of(group)
    if pg is None or n == 1:
        raise RuntimeError(f"send(): a world of one has no peer rank {dst}")
    _send(plain(tensor).detach(), dst, pg)
    return tensor


def recv(tensor=None, src=0, group=None, sync_op=True, shape=None,
         dtype=None):
    """reference: recv_v2_op.cc: the next message from the group's rank
    `src`, into `tensor` (or a new tensor of shape/dtype)."""
    pg, n = _pg_of(group)
    if pg is None or n == 1:
        raise RuntimeError(f"recv(): a world of one has no peer rank {src}")
    if tensor is None:
        from ..core.dtypes import convert_dtype
        tensor = torch.empty(list(shape), dtype=convert_dtype(dtype)
                             or torch.float32)
        return box(_recv(tensor, src, pg))
    _recv(plain(tensor).data, src, pg)
    return tensor


def get_world_size(group=None):
    """The group's size (the job's for the default group with no mesh)."""
    g = _resolve_group(group)
    if g is _default_group and _mesh.get_global_mesh() is None:
        return _mesh.world_size()
    return g.nranks


def get_rank(group=None):
    """This process's rank in the job."""
    return _mesh.world_rank()


def axis_index(group=None):
    """This rank's position along the group's mesh axis."""
    g = _resolve_group(group)
    m = _mesh.get_global_mesh()
    return m.coord(g.axis) if m is not None else get_rank()


# ------------------------------------------------- c_* op-level aliases
def _ring_group(ring_id):
    return get_group(ring_id) if ring_id in _groups \
        else Group(_mesh.ring_axis(ring_id), ring_id=ring_id)


def _c_reduce(x, ring_id, op):
    out = box(plain(x).detach().clone())
    return all_reduce(out, op, _ring_group(ring_id))


def c_allreduce_sum(x, ring_id=0, use_calc_stream=True):
    return _c_reduce(x, ring_id, ReduceOp.SUM)


def c_allreduce_max(x, ring_id=0, use_calc_stream=True):
    return _c_reduce(x, ring_id, ReduceOp.MAX)


def c_allreduce_min(x, ring_id=0, use_calc_stream=True):
    return _c_reduce(x, ring_id, ReduceOp.MIN)


def c_allreduce_prod(x, ring_id=0, use_calc_stream=True):
    return _c_reduce(x, ring_id, ReduceOp.PROD)


def c_broadcast(x, root=0, ring_id=0, use_calc_stream=True):
    return broadcast(box(plain(x).detach().clone()), root,
                     _ring_group(ring_id))


def c_allgather(x, nranks=None, ring_id=0, use_calc_stream=True):
    """The group's x, concatenated on dim 0."""
    parts = all_gather([], x, _ring_group(ring_id))
    return box(torch.cat([plain(p) for p in parts], dim=0))


def c_reducescatter(x, nranks=None, ring_id=0, use_calc_stream=True):
    """This rank's dim-0 chunk of the group's summed x."""
    g = _ring_group(ring_id)
    _, n = _pg_of(g)
    t = plain(x).detach()
    out = box(torch.empty((t.shape[0] // n,) + tuple(t.shape[1:]),
                          dtype=t.dtype, device=t.device))
    return reduce_scatter(out, t, ReduceOp.SUM, g)


def c_sync_calc_stream(x):
    return x  # one stream per device: the collectives are ordered on it


def c_sync_comm_stream(x, ring_id=0):
    return x


def c_gen_nccl_id(*a, **k):
    """reference: c_gen_nccl_id_op.cc. init_parallel_env's TCP store
    owns the bootstrap; nothing to generate."""
    return None


def c_comm_init(ring_id=0, axis="dp", *a, **k):
    _mesh.register_ring(ring_id, axis)


def wait(tensor, group=None, use_calc_stream=True):
    """Wait for the work on `tensor`'s device."""
    t = plain(tensor)
    if torch.is_tensor(t) and t.is_cuda:
        torch.cuda.current_stream(t.device).synchronize()
    return tensor
