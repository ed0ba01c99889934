"""Layers of the port: thin ``torch.nn.Module``s."""
from .layer.common import Embedding, Linear
from .layer.norm import RMSNorm

__all__ = ["Embedding", "Linear", "RMSNorm"]
