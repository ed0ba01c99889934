"""Serving path of the port: paged decoder, continuous batching, the
workload scheduler and speculative decoding."""
from .continuous import (ContinuousBatchingEngine,  # noqa: F401
                         DeadlineExceeded, EngineDraining, EngineSaturated,
                         RequestCancelled)
from .paged import PagedGenerator  # noqa: F401
from .speculative import SpeculativeGenerator  # noqa: F401
from .scheduler import (DEFAULT_CLASS, DEFAULT_CLASSES,  # noqa: F401
                        PriorityClass, QueueFull, WorkloadScheduler)
