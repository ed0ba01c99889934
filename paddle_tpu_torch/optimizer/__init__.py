"""Optimizers and learning-rate schedules (port of paddle_tpu/optimizer)."""
from . import lr
from .optimizer import SGD, Adam, AdamW, L2Decay, Optimizer

__all__ = ["Adam", "AdamW", "L2Decay", "Optimizer", "SGD", "lr"]
