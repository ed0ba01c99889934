"""The high-level API (port of paddle_tpu/hapi): ``Model`` and the fit
loop's callbacks.  ``hub.py`` is not ported yet (its sources need
``utils.download``)."""
from .model import DeferredScalar, Model  # noqa: F401

__all__ = ["DeferredScalar", "Model"]
