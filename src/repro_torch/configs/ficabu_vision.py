"""The paper's own evaluation model: ResNet-18 on CIFAR-20-like data.
(ViT comes with a later slice of the port.)"""
from repro_torch.models.vision import ResNetConfig

RESNET18_CIFAR20 = ResNetConfig(name="resnet18-cifar20", n_classes=20, width=64)
RESNET18_SMALL = ResNetConfig(name="resnet18-small", n_classes=8, width=16)
