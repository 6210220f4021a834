"""incubate of the port (paddle_tpu/incubate): the optimizer wrappers
(`incubate.optimizer`) and checkpoint's integrity manifest
(`incubate.checkpoint`, the part the serving model registry needs).
The rest of checkpoint, LayerHelper, load_op_library and reader are not
ported yet (ROADMAP Queue 1)."""
from . import checkpoint, optimizer

__all__ = ["checkpoint", "optimizer"]
