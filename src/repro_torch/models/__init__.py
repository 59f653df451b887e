from . import layers, module, vision  # noqa: F401
from .vision import ResNetConfig, ViTConfig  # noqa: F401
