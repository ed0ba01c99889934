"""Whole training steps (port of paddle_tpu/jit)."""
from .train_step import TrainStep

__all__ = ["TrainStep"]
