"""paddle_tpu_torch.profiler — host event recording (``record.py``).

The port of ``paddle_tpu.profiler``'s recorder: ``RecordEvent`` spans and
the process-wide recorder that ``monitor.span`` and the trace capture
window push to.  The profiler's scheduler, summary statistics and native
recorder are not ported.
"""
from .record import (HostEvent, RecordEvent, get_recorder,  # noqa: F401
                     record_function)

__all__ = ["HostEvent", "RecordEvent", "get_recorder", "record_function"]
