"""DistributeTranspiler, the legacy parameter-server transpile API (port
of paddle_tpu/distributed/transpiler.py, in part; reference:
python/paddle/fluid/transpiler/distribute_transpiler.py).

The JAX package's transpile() splits a recorded static Program at its
backward op (paddle_tpu/distributed/transpiler.py:138-195) into a
trainer program and per-endpoint pserver programs over distributed/ps.
The port has no static Program yet, so DistributeTranspiler raises,
naming slice 10 (beside static/); its config is kept as the JAX
package's, and the runtime it would drive (distributed/ps, fleet's
init_server / init_worker) is ported.
"""
from __future__ import annotations

from typing import Optional

from ..core.unported import not_ported

__all__ = ["DistributeTranspilerConfig", "DistributeTranspiler"]


class DistributeTranspilerConfig:
    """reference: the transpiler's config knobs, recorded as the JAX
    package records them."""

    def __init__(self):
        self.slice_var_up = True
        self.min_block_size = 8192
        self.split_method = None
        self.sync_mode = True


class DistributeTranspiler:
    def __init__(self, config: Optional[DistributeTranspilerConfig] = None):
        not_ported("DistributeTranspiler (it splits a static Program at "
                   "its backward op)", "slice 10, beside static/")
