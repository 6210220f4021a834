"""The rank mesh (port of paddle_tpu/parallel/mesh.py).

The JAX package names the TPU topology with a jax.sharding.Mesh over
its devices and lets XLA emit the collectives of each axis. The port
runs one process per GPU over torch.distributed, so its mesh is a grid
of RANKS with the JAX axis order, `dp, pp, sharding, sp, ep, tp` (tp
innermost: a tensor-parallel group holds consecutive ranks, which on
one host share NVLink), and one process group per axis. `group(axes)`
is the process group of this rank along one axis or several (the
data-parallel mean of ShardedTrainStep runs over `("dp", "sharding")`).

Groups are made with `torch.distributed.new_group`, which every rank of
the world must call for every group in the same order: `build_mesh`
makes the group of each axis whose size is neither 1 nor the world's
at once (every rank builds the same mesh), and `group` makes a group of
several axes the first time it is asked for (SPMD code asks in the same
order on every rank). An axis of size 1 has no group (its collectives
are the identity), but when the whole world is one rank the world group
stands for every axis, so that a run on one GPU still goes through
NCCL. Without an initialised process group, `group` returns None and
the collectives over it are the identity (a world of one).

The ring_id -> axis registry keeps the reference's multi-ring API
(c_comm_init's ring_id); `named_sharding` and `replicated` return the
(mesh, spec) pair the JAX package builds a NamedSharding from.
"""
from __future__ import annotations

import itertools
import os
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch.distributed as dist

__all__ = ["TopologyError", "RankMesh", "build_mesh", "set_global_mesh",
           "get_global_mesh", "ensure_global_mesh", "register_ring",
           "ring_axis", "named_sharding", "replicated"]

AXES = ("dp", "pp", "sharding", "sp", "ep", "tp")


class TopologyError(ValueError):
    pass


def world_size() -> int:
    """Ranks in the job: the process group's, else the launcher's env."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))


def world_rank() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return int(os.environ.get("PADDLE_TRAINER_ID", "0"))


class RankMesh:
    """A grid of ranks over AXES. `shape` maps each axis to its size,
    `devices` is the rank grid, `coord(axis)` this rank's place along an
    axis, `group(axes)` its process group along them. `batch_axes` are
    the axes the batch's rows are split over (the JAX package's
    canonical batch layout, ("dp", "sharding"), until a ShardedTrainStep
    sets its batch_spec): MoE routing reads the batch whole across them."""

    axis_names = AXES

    def __init__(self, ranks: np.ndarray):
        self.devices = np.asarray(ranks)
        self.shape: Dict[str, int] = dict(zip(AXES, self.devices.shape))
        self.batch_axes: Tuple[str, ...] = ("dp", "sharding")
        self._groups: Dict[Tuple[str, ...], object] = {}

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def _where(self, rank=None) -> Tuple[int, ...]:
        rank = world_rank() if rank is None else rank
        hit = np.argwhere(self.devices == rank)
        if not len(hit):
            raise TopologyError(f"rank {rank} is not on the mesh")
        return tuple(int(i) for i in hit[0])

    def coord(self, axis: str, rank=None) -> int:
        """This rank's index along `axis` (or along several, row-major)."""
        axes = _axes(axis)
        where = self._where(rank)
        idx = 0
        for a in axes:
            i = AXES.index(a)
            idx = idx * self.devices.shape[i] + where[i]
        return idx

    def axis_size(self, axis) -> int:
        n = 1
        for a in _axes(axis):
            n *= self.shape[a]
        return n

    def group_ranks(self, axis, rank=None) -> list:
        """The ranks of this rank's group along `axis`, in axis order."""
        axes = _axes(axis)
        where = list(self._where(rank))
        return [int(self.devices[tuple(_at(where, axes, c))])
                for c in itertools.product(
                    *[range(self.shape[a]) for a in axes])]

    def _partition(self, axes):
        """Every group of the world along `axes`, in a fixed order."""
        others = [a for a in AXES if a not in axes]
        out = []
        for fixed in itertools.product(*[range(self.shape[a])
                                         for a in others]):
            where = [0] * len(AXES)
            for a, c in zip(others, fixed):
                where[AXES.index(a)] = c
            out.append([int(self.devices[tuple(_at(where, axes, c))])
                        for c in itertools.product(
                            *[range(self.shape[a]) for a in axes])])
        return out

    def group(self, axis):
        """This rank's process group along `axis` (a name or a tuple of
        names); None when it is a group of one in a larger world or no
        process group is initialised (see the module docstring)."""
        axes = _axes(axis)
        if not axes or not (dist.is_available() and dist.is_initialized()):
            return None
        n = self.axis_size(axes)
        if n == dist.get_world_size():
            return dist.group.WORLD
        if n == 1:
            return None
        if axes not in self._groups:
            me, mine = world_rank(), None
            for ranks in self._partition(axes):
                g = dist.new_group(ranks)
                if me in ranks:
                    mine = g
            self._groups[axes] = mine
        return self._groups[axes]

    def __repr__(self):
        return f"RankMesh({self.shape})"


def _axes(axis) -> Tuple[str, ...]:
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    bad = [a for a in axes if a not in AXES]
    if bad:
        raise ValueError(f"unknown mesh axes {bad}; the axes are {AXES}")
    return tuple(a for a in AXES if a in axes)


def _at(where, axes, coords):
    out = list(where)
    for a, c in zip(axes, coords):
        out[AXES.index(a)] = c
    return out


_global_mesh: Optional[RankMesh] = None
_ring_axes: Dict[int, str] = {}   # ring_id -> mesh axis (reference parity)


def build_mesh(dp: int = 1, pp: int = 1, tp: int = 1, sp: int = 1,
               sharding: int = 1, ep: int = 1, devices=None) -> RankMesh:
    """A mesh over the ranks `devices` (all ranks of the job by default)
    in the JAX axis order; the degrees must multiply to their count."""
    ranks = list(devices if devices is not None else range(world_size()))
    want = dp * pp * tp * sp * sharding * ep
    if want != len(ranks):
        raise TopologyError(
            f"mesh degrees dp={dp}×pp={pp}×tp={tp}×sp={sp}×"
            f"sharding={sharding}×ep={ep} = {want} != "
            f"{len(ranks)} devices")
    mesh = RankMesh(np.asarray(ranks).reshape(dp, pp, sharding, sp, ep, tp))
    if dist.is_available() and dist.is_initialized() \
            and len(ranks) == dist.get_world_size():
        for a in AXES:
            mesh.group(a)
    return mesh


def set_global_mesh(mesh: Optional[RankMesh]):
    global _global_mesh
    _global_mesh = mesh


def get_global_mesh() -> Optional[RankMesh]:
    return _global_mesh


def ensure_global_mesh(**degrees) -> RankMesh:
    global _global_mesh
    if _global_mesh is None:
        _global_mesh = build_mesh(**degrees) if degrees \
            else build_mesh(dp=world_size())
    return _global_mesh


def register_ring(ring_id: int, axis: str):
    """reference parity: c_comm_init binds a ring_id to a communicator;
    here a ring is a mesh axis name."""
    _ring_axes[ring_id] = axis


def ring_axis(ring_id: int) -> str:
    return _ring_axes.get(ring_id, "dp")


class Sharding(NamedTuple):
    """A layout over a mesh: per dimension, the axis it is split over or
    None (the JAX package's NamedSharding(mesh, PartitionSpec(*spec)))."""
    mesh: RankMesh
    spec: tuple


def named_sharding(mesh: RankMesh, *spec) -> Sharding:
    return Sharding(mesh, tuple(spec))


def replicated(mesh: RankMesh) -> Sharding:
    return Sharding(mesh, ())
