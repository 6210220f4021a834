"""Fleet utils: recompute and the file-system helpers (port of
paddle_tpu/distributed/fleet/utils.py).

`recompute(function, *args, preserve_rng_state=True, **kwargs)` runs
`function` without keeping its activations for backward and runs it
again inside backward (the reference's RecomputeFunction; in the JAX
package jax.checkpoint under a trace, a tape node that re-runs the
function when eager). Here it is torch.utils.checkpoint.checkpoint with
use_reentrant=False, which works under torch.autograd.grad (the train
steps' backward) and recomputes lazily. The rerun reproduces the first
run:
- the port's random draws (dropout's masks) come from its own
  generators (core/random.py), which torch's preserve_rng_state does not
  cover. Every generator of the port is snapshotted before the forward,
  set back to the snapshot for the rerun, and put back after it, so the
  rerun draws the masks of the first run (the JAX package pins one key
  for the function, `trace_key_scope`, whatever preserve_rng_state says;
  the flag goes on to torch's checkpoint for torch's own streams);
- the rerun runs under the auto_cast state, the op-boundary depth and
  the plain dispatch of the first run (torch restores only its own
  autocast).
So recomputed activations are bitwise those of the first run.

`LocalFS` and `HDFSClient` are the reference's: local paths, and an
HDFS client that falls back to them (no HDFS here).
"""
from __future__ import annotations

import contextlib
import os
import shutil

import torch

from ...amp.auto_cast import current as _amp_state
from ...amp.auto_cast import restored as _amp_restored
from ...core import random as _random
from ...core.dispatch import _State, has_tensor, outermost
from ...core.tensor import _DIS

__all__ = ["recompute", "LocalFS", "HDFSClient"]


@contextlib.contextmanager
def _rerun(states, amp, depth, plain):
    """The first run's generator states, casts, depth and dispatch for
    the body; the current generator states afterwards."""
    now = [(g, g.get_state()) for g, _ in states]
    for g, st in states:
        g.set_state(st)
    outer_depth, _State.depth = _State.depth, depth
    try:
        with _amp_restored(amp), (_DIS() if plain
                                  else contextlib.nullcontext()):
            yield
    finally:
        _State.depth = outer_depth
        for g, st in now:
            g.set_state(st)


def _contexts(args):
    """context_fn of torch's checkpoint: nothing around the first run,
    the first run's state around the rerun."""
    for a in args:
        if torch.is_tensor(a):
            _random.generator(a.device)  # made now, so it is snapshotted
    states = [(g, g.get_state()) for g in _random._generators.values()]
    return contextlib.nullcontext(), _rerun(
        states, _amp_state(), _State.depth,
        not torch._C._is_torch_function_enabled())


def _checkpoint(function, preserve_rng_state, *args, **kwargs):
    from torch.utils.checkpoint import checkpoint
    return checkpoint(function, *args, use_reentrant=False,
                      preserve_rng_state=preserve_rng_state,
                      context_fn=lambda: _contexts(args), **kwargs)


def recompute(function, *args, preserve_rng_state=True, **kwargs):
    """function(*args, **kwargs), its activations recomputed in backward
    instead of kept (see the module docstring). At user level, Tensor
    arguments go in as plain tensors and the results come back as
    Tensors, as at every op boundary."""
    if not _State.depth and has_tensor(args, kwargs):
        return outermost(_checkpoint, function, preserve_rng_state, *args,
                         **kwargs)
    return _checkpoint(function, preserve_rng_state, *args, **kwargs)


class LocalFS:
    """reference: fleet/utils/fs.py LocalFS."""

    def ls_dir(self, path):
        if not os.path.exists(path):
            return [], []
        dirs, files = [], []
        for n in sorted(os.listdir(path)):
            (dirs if os.path.isdir(os.path.join(path, n)) else
             files).append(n)
        return dirs, files

    def mkdirs(self, path):
        os.makedirs(path, exist_ok=True)

    def is_exist(self, path):
        return os.path.exists(path)

    def delete(self, path):
        if os.path.isdir(path):
            shutil.rmtree(path, ignore_errors=True)
        elif os.path.exists(path):
            os.remove(path)

    def touch(self, path, exist_ok=True):
        open(path, "a").close()

    def mv(self, src, dst, overwrite=False):
        shutil.move(src, dst)

    def upload(self, local, remote):
        shutil.copy(local, remote)

    def download(self, remote, local):
        shutil.copy(remote, local)


class HDFSClient(LocalFS):
    """reference: fleet/utils/fs.py HDFSClient. There is no HDFS here:
    the local paths keep checkpoint code running, as in the JAX
    package."""

    def __init__(self, hadoop_home=None, configs=None):
        pass
