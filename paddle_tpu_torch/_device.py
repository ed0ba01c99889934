"""Device resolution and small host-to-device writes shared by the
port's entry points."""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device) -> torch.device:
    """``torch.device`` for an entry point's ``device`` argument.  The
    entry points default to ``"cuda"``; asking for CUDA where there is
    none raises instead of quietly running the plain versions on the
    CPU (pass ``device="cpu"`` for that)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Upload:
    """Small host-to-device writes through a ring of host slots, pinned
    when the device is a card: a slot is filled again only after the copy
    that last read it has run, so the host may queue steps ahead of the
    card without rewriting a copy still pending."""

    SLOTS = 8
    BYTES = 64

    def __init__(self, device):
        card = device.type == "cuda"
        self._host = torch.zeros((self.SLOTS, self.BYTES), dtype=torch.uint8,
                                 pin_memory=card)
        self._copied = [torch.cuda.Event() if card else None
                        for _ in range(self.SLOTS)]
        self._next = 0

    def __call__(self, dst: torch.Tensor, values: np.ndarray) -> None:
        """``values`` (numpy, ``dst``'s dtype and size) into ``dst``, a
        contiguous device tensor, in one copy, not waited on."""
        i = self._next
        self._next = (i + 1) % self.SLOTS
        if self._copied[i] is not None:
            self._copied[i].synchronize()
        raw = np.ascontiguousarray(values).view(np.uint8)
        slot = self._host[i, :raw.size]
        slot.numpy()[:] = raw
        dst.view(torch.uint8).copy_(slot, non_blocking=True)
        if self._copied[i] is not None:
            self._copied[i].record(torch.cuda.current_stream(dst.device))
