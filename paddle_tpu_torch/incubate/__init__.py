"""incubate of the port (paddle_tpu/incubate): the optimizer wrappers
(`incubate.optimizer`) and the auto-checkpoint manager with its
integrity manifest (`incubate.checkpoint`). LayerHelper,
load_op_library and reader are not ported yet (ROADMAP Queue 1)."""
from . import checkpoint, optimizer

__all__ = ["checkpoint", "optimizer"]
