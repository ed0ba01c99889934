"""paddle_tpu_torch.testing — deterministic test harnesses for the port.

``faults`` is the seeded fault-injection plan the serving engine and the
page allocator consult (a copy of ``paddle_tpu.testing.faults``): tests
and the card's smoke run drive failures through the same code paths real
failures take, at one ``is None`` check when no plan is installed.
"""
from . import faults  # noqa: F401

__all__ = ["faults"]
