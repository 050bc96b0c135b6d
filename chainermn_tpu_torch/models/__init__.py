"""Models: the ResNet family and the MNIST MLP (see ``resnet`` and ``mlp``)."""

from .mlp import MLP, accuracy, cross_entropy_loss  # noqa: F401
from .resnet import (ARCHS, BasicBlock, BatchNorm,  # noqa: F401
                     BottleneckBlock, Conv, PallasConv, ResNet, make_norm)
