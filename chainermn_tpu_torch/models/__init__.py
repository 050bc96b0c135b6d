"""Models: the ResNets, the NF-ResNets, the convnet zoo (``convnets``), ViT
(``vit``) and the MNIST MLP; ``ARCHS`` is the ImageNet registry."""

from .mlp import MLP, accuracy, cross_entropy_loss  # noqa: F401
from .resnet import (ARCHS, Affine, BasicBlock, BatchNorm,  # noqa: F401
                     BottleneckBlock, Conv, Dense, NFResNet, PallasConv,
                     ResNet, ScaledWSConv, StaleBatchNorm, make_norm)
