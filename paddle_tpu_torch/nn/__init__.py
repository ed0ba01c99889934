"""Layers of the port: thin ``torch.nn.Module``s."""
from . import functional
from .clip import ClipGradByGlobalNorm
from .layer.common import Embedding, Linear
from .layer.norm import RMSNorm

__all__ = ["ClipGradByGlobalNorm", "Embedding", "Linear", "RMSNorm",
           "functional"]
