"""Model configurations of the port (the paper's vision models)."""
from .ficabu_vision import (RESNET18_CIFAR20, RESNET18_SMALL,  # noqa: F401
                            VIT_CIFAR20, VIT_SMALL)
