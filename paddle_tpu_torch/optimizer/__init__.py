"""Optimizers and learning-rate schedules (port of paddle_tpu/optimizer)."""
from . import lr
from .optimizer import (ASGD, SGD, Adadelta, Adagrad, Adam, Adamax, AdamW,
                        L1Decay, L2Decay, Lamb, Momentum, NAdam, Optimizer,
                        RAdam, RMSProp, Rprop, WeightDecayRegularizer)

__all__ = ["ASGD", "Adadelta", "Adagrad", "Adam", "AdamW", "Adamax",
           "L1Decay", "L2Decay", "Lamb", "Momentum", "NAdam", "Optimizer",
           "RAdam", "RMSProp", "Rprop", "SGD", "WeightDecayRegularizer",
           "lr"]
