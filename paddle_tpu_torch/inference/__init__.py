"""Serving path of the port: paged decoder, continuous batching, the
workload scheduler, speculative decoding, the write-ahead request journal
and the HTTP server."""
from .continuous import (ContinuousBatchingEngine,  # noqa: F401
                         DeadlineExceeded, EngineDraining, EngineSaturated,
                         RequestCancelled)
from .journal import RequestJournal  # noqa: F401
from .paged import PagedGenerator  # noqa: F401
from .server import GenerationServer  # noqa: F401
from .speculative import SpeculativeGenerator  # noqa: F401
from .scheduler import (DEFAULT_CLASS, DEFAULT_CLASSES,  # noqa: F401
                        PriorityClass, QueueFull, WorkloadScheduler)
