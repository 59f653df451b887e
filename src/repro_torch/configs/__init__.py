"""Model configurations of the port (the paper's vision model so far)."""
from .ficabu_vision import RESNET18_CIFAR20, RESNET18_SMALL  # noqa: F401
