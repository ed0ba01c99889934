"""Gradient clipping (port of paddle_tpu/nn/clip.py
``ClipGradByGlobalNorm``), consumed by the optimizer's ``grad_clip``."""
from __future__ import annotations

import torch


class ClipGradByGlobalNorm:
    """Scale every gradient by min(1, clip_norm / global_norm), where the
    global norm is the f32 L2 norm over all clipped gradients.  A
    parameter whose ``need_clip`` attribute is False is neither counted
    nor scaled.  Takes (param, grad) pairs and returns new pairs with
    the scaled grads, on the device (no host sync); the grads it was
    given, ``p.grad`` among them, are left as they were."""

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
        scaled = iter(torch._foreach_mul(grads, scale))
        return [(p, next(scaled)
                 if g is not None and getattr(p, "need_clip", True) else g)
                for p, g in params_grads]
