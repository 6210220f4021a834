"""paddle.distributed.fleet (port of paddle_tpu/distributed/fleet/):
for now `utils` and its `recompute`.

Not ported yet (ROADMAP Queue 1 item 7, multi-GPU): `fleet_base` (the
`fleet` singleton, init / distributed_model / distributed_optimizer /
distributed_train_step), `DistributedStrategy`, the role makers,
`data_generator` and `metrics`.
"""
from . import utils  # noqa: F401
from .utils import recompute  # noqa: F401

__all__ = ["utils", "recompute"]
