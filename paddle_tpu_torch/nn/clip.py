"""Gradient clipping (port of paddle_tpu/nn/clip.py
``ClipGradByGlobalNorm``), consumed by the optimizer's ``grad_clip``."""
from __future__ import annotations

import torch


class ClipGradByGlobalNorm:
    """Scale every gradient by min(1, clip_norm / global_norm), where the
    global norm is the f32 L2 norm over all clipped gradients.  A
    parameter whose ``need_clip`` attribute is False is neither counted
    nor scaled.  Takes and returns (param, grad) pairs; scales the grads
    in place, on the device (no host sync)."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        grads = [g for p, g in params_grads
                 if g is not None and getattr(p, "need_clip", True)]
        if not grads:
            return params_grads
        norms = torch._foreach_norm(grads, 2, dtype=torch.float32)
        global_norm = torch.linalg.vector_norm(torch.stack(norms))
        scale = torch.clamp_max(self.clip_norm
                                / torch.clamp_min(global_norm, 1e-12), 1.0)
        torch._foreach_mul_(grads, scale)
        return params_grads
