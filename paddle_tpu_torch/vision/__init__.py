"""Vision models of the port (port of paddle_tpu/vision): the ResNets."""
from . import models

__all__ = ["models"]
