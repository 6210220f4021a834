"""vision of the port (paddle_tpu/vision): the model zoo's LeNet,
ResNets, MobileNetV1/V2 and VGG. datasets, transforms, image and ops
wait for the data slice (ROADMAP Queue 1 item 8)."""
from . import models
from .models import (LeNet, MobileNetV1, MobileNetV2, ResNet, resnet18,
                     resnet50)

__all__ = ["models", "LeNet", "ResNet", "resnet18", "resnet50",
           "MobileNetV1", "MobileNetV2"]
