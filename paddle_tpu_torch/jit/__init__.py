"""Whole training steps (port of paddle_tpu/jit)."""
from .train_step import EagerTrainStep, TrainStep

__all__ = ["EagerTrainStep", "TrainStep"]
