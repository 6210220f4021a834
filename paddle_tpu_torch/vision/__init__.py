"""vision of the port (paddle_tpu/vision): the model zoo's LeNet,
ResNets, MobileNetV1/V2 and VGG, the datasets (local files or synthetic
data), the transforms and the image backends. `ops` (detection ops)
waits for slice 10 (ROADMAP Queue 1 item 8)."""
from . import datasets, image, models, transforms
from .models import (LeNet, MobileNetV1, MobileNetV2, ResNet, resnet18,
                     resnet50)
from .image import get_image_backend, image_load, set_image_backend

__all__ = ["datasets", "models", "transforms", "image", "LeNet", "ResNet",
           "resnet18", "resnet50", "MobileNetV1", "MobileNetV2",
           "set_image_backend", "get_image_backend", "image_load"]
