"""vision of the port (paddle_tpu/vision): the model zoo's LeNet and
ResNets."""
from . import models

__all__ = ["models"]
