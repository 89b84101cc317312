"""Vision models of the port (``vision.models``: LeNet and the ResNet
family)."""
from . import models

__all__ = ["models"]
