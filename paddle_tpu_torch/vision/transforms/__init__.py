"""paddle.vision.transforms of the port (paddle_tpu/vision/transforms):
numpy-based, CHW float32 output, the JAX package's classes and
functionals (resize in torch with jax.image.resize's weights)."""
from .transforms import (  # noqa: F401
    Compose, ToTensor, Normalize, Resize, RandomResizedCrop, CenterCrop,
    RandomHorizontalFlip, RandomVerticalFlip, RandomCrop, Pad, Transpose,
    BrightnessTransform, ContrastTransform, SaturationTransform, ColorJitter,
    RandomRotation, Grayscale,
)
from . import functional  # noqa: F401
