"""Serving path of the port: paged decoder, continuous batching and the
workload scheduler."""
from .continuous import (ContinuousBatchingEngine,  # noqa: F401
                         DeadlineExceeded, EngineDraining, EngineSaturated,
                         RequestCancelled)
from .paged import PagedGenerator  # noqa: F401
from .scheduler import (DEFAULT_CLASS, DEFAULT_CLASSES,  # noqa: F401
                        PriorityClass, QueueFull, WorkloadScheduler)
