"""incubate of the port (paddle_tpu/incubate): the optimizer wrappers
(`incubate.optimizer`). checkpoint, LayerHelper, load_op_library and
reader are not ported yet (ROADMAP Queue 1)."""
from . import optimizer

__all__ = ["optimizer"]
