from . import mobilenet as mobilenetv1  # noqa: F401
from . import mobilenet as mobilenetv2  # noqa: F401
from .lenet import LeNet
from .mobilenet import (MobileNetV1, MobileNetV2, mobilenet_v1,
                        mobilenet_v2)
from .resnet import (BasicBlock, BottleneckBlock, ResNet, resnet18, resnet34,
                     resnet50, resnet101, resnet152, resnext50_32x4d,
                     wide_resnet50_2)
from .vgg import VGG, vgg11, vgg13, vgg16, vgg19

__all__ = ["LeNet", "ResNet", "BasicBlock", "BottleneckBlock", "resnet18",
           "resnet34", "resnet50", "resnet101", "resnet152", "wide_resnet50_2",
           "resnext50_32x4d", "MobileNetV1", "MobileNetV2", "mobilenet_v1",
           "mobilenet_v2", "VGG", "vgg11", "vgg13", "vgg16", "vgg19",
           "mobilenetv1", "mobilenetv2"]
