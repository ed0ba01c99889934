"""Incubating layers and functions of the port (port of
paddle_tpu/incubate/nn)."""
from . import functional

__all__ = ["functional"]
