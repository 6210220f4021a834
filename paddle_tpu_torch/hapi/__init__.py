"""paddle hapi of the port (paddle_tpu/hapi): Model.fit / evaluate /
predict over jit.TrainStep, the callbacks, summary and flops."""
from .model import Model  # noqa: F401
from .model_summary import summary, flops  # noqa: F401
from . import callbacks  # noqa: F401
from .callbacks import (  # noqa: F401
    Callback, ProgBarLogger, ModelCheckpoint, EarlyStopping, LRScheduler,
)
