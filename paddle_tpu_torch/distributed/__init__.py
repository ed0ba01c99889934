"""paddle_tpu_torch.distributed — the port's distributed runtime.

So far the watchdog's heartbeat half (``watchdog.CommTaskManager``),
which the serving engine's step watchdog registers with, and
tensor-parallel serving's process group (``tensor_parallel``: a spawned
process a rank, rank 0 planning every step), and group-sharded training
on one rank with ZeRO offload (``sharding``); collectives, fleet and the
comm-task half of the watchdog come with the port of
``paddle_tpu/distributed``.
"""
from .sharding import (group_sharded_parallel,  # noqa: F401
                       save_group_sharded_model)
from .tensor_parallel import (TensorParallelError,  # noqa: F401
                              TensorParallelGroup)
from .watchdog import CommTaskManager  # noqa: F401

__all__ = ["CommTaskManager", "TensorParallelError", "TensorParallelGroup",
           "group_sharded_parallel", "save_group_sharded_model"]
