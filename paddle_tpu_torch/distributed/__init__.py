"""paddle_tpu_torch.distributed — the port's distributed runtime.

So far only the watchdog's heartbeat half (``watchdog.CommTaskManager``),
which the serving engine's step watchdog registers with; collectives,
fleet and the comm-task half of the watchdog come with the port of
``paddle_tpu/distributed``.
"""
from .watchdog import CommTaskManager  # noqa: F401

__all__ = ["CommTaskManager"]
