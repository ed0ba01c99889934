"""``paddle_tpu_torch.callbacks`` (port of paddle_tpu/callbacks.py): the
hapi callback set re-exported."""
from .hapi.callbacks import (  # noqa: F401
    Callback, EarlyStopping, LRScheduler, ModelCheckpoint, MonitorCallback,
    ProgBarLogger, ReduceLROnPlateau, VisualDL,
)

__all__ = ["Callback", "ProgBarLogger", "ModelCheckpoint", "LRScheduler",
           "EarlyStopping", "ReduceLROnPlateau", "VisualDL",
           "MonitorCallback"]
