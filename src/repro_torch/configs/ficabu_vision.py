"""The paper's own evaluation models: ResNet-18 and ViT on CIFAR-20-like
data."""
from repro_torch.models.vision import ResNetConfig, ViTConfig

RESNET18_CIFAR20 = ResNetConfig(name="resnet18-cifar20", n_classes=20, width=64)
RESNET18_SMALL = ResNetConfig(name="resnet18-small", n_classes=8, width=16)

VIT_CIFAR20 = ViTConfig(name="vit-cifar20", n_classes=20, n_layers=12,
                        d_model=192, n_heads=3, d_ff=768)
VIT_SMALL = ViTConfig(name="vit-small", n_classes=8, n_layers=6,
                      d_model=64, n_heads=2, d_ff=128)
