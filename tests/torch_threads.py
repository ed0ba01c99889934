"""One intra-op thread for torch in the port's CPU tests (every
``tests/test_torch_*.py`` that runs on the CPU imports this module).

Tier-1 runs the tests in six pytest-xdist processes on an eight-core
machine, each importing every test file.  With torch's default of one
intra-op thread a core, six processes' pools oversubscribe the cores and
the port's test cases summed 2082 s; on one thread each, 1268 s, every
case passing (``tests/test_torch_*.py`` under that command, measured on
the CPU sandbox the tests run in).  The small shapes of these tests gain
nothing from intra-op threads."""
import torch

torch.set_num_threads(1)
