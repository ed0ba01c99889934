"""Framework pieces of the port (port of paddle_tpu/framework): so far
``save`` and ``load``."""
from .io import load, save

__all__ = ["load", "save"]
