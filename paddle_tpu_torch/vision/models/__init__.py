"""Vision models of the port (port of paddle_tpu/vision/models): the
ResNets of ``resnet.py``, LeNet / AlexNet / VGG / SqueezeNet of
``small_nets.py``, MobileNet V1-V3 / ShuffleNetV2 / DenseNet of
``mobilenets.py`` and GoogLeNet / InceptionV3 of ``inception.py``: every
name the JAX package exports."""
from .inception import GoogLeNet, InceptionV3, googlenet, inception_v3
from .mobilenets import (DenseNet, MobileNetV1, MobileNetV2,
                         MobileNetV3Large, MobileNetV3Small, ShuffleNetV2,
                         densenet121, densenet161, densenet169, densenet201,
                         densenet264, mobilenet_v1, mobilenet_v2,
                         mobilenet_v3_large, mobilenet_v3_small,
                         shufflenet_v2_swish, shufflenet_v2_x0_5,
                         shufflenet_v2_x0_25, shufflenet_v2_x0_33,
                         shufflenet_v2_x1_0, shufflenet_v2_x1_5,
                         shufflenet_v2_x2_0)
from .resnet import (BasicBlock, BottleneckBlock, ResNet, resnet18,
                     resnet34, resnet50, resnet101, resnet152,
                     resnext50_32x4d, resnext50_64x4d, resnext101_32x4d,
                     resnext101_64x4d, resnext152_32x4d, resnext152_64x4d,
                     wide_resnet50_2, wide_resnet101_2)
from .small_nets import (VGG, AlexNet, LeNet, SqueezeNet, alexnet,
                         squeezenet1_0, squeezenet1_1, vgg11, vgg13, vgg16,
                         vgg19)

__all__ = ["BasicBlock", "BottleneckBlock", "ResNet", "resnet18",
           "resnet34", "resnet50", "resnet101", "resnet152",
           "resnext50_32x4d", "resnext50_64x4d", "resnext101_32x4d",
           "resnext101_64x4d", "resnext152_32x4d", "resnext152_64x4d",
           "wide_resnet50_2", "wide_resnet101_2",
           "LeNet", "AlexNet", "VGG", "SqueezeNet", "alexnet", "vgg11",
           "vgg13", "vgg16", "vgg19", "squeezenet1_0", "squeezenet1_1",
           "MobileNetV1", "MobileNetV2", "MobileNetV3Small",
           "MobileNetV3Large", "ShuffleNetV2", "DenseNet", "mobilenet_v1",
           "mobilenet_v2", "mobilenet_v3_small", "mobilenet_v3_large",
           "shufflenet_v2_x1_0", "densenet121", "densenet161",
           "densenet169", "densenet201", "densenet264",
           "shufflenet_v2_x0_25", "shufflenet_v2_x0_33",
           "shufflenet_v2_x0_5", "shufflenet_v2_x1_5", "shufflenet_v2_x2_0",
           "shufflenet_v2_swish", "GoogLeNet", "InceptionV3", "googlenet",
           "inception_v3"]
