"""nn.functional.extension (port of paddle_tpu/nn/functional/
extension.py): diag_embed, gather_tree and temporal_shift, re-exported
from the ops."""
from ...ops.creation import diag_embed  # noqa: F401
from ...ops.extra_ops import gather_tree  # noqa: F401
from ...ops.vision_ops import temporal_shift  # noqa: F401

__all__ = ["diag_embed", "gather_tree", "temporal_shift"]
