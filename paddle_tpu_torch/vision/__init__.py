"""Vision models of the port (port of paddle_tpu/vision): the model zoo
of ``models``."""
from . import models

__all__ = ["models"]
