from . import module, vision  # noqa: F401
from .vision import ResNetConfig  # noqa: F401
