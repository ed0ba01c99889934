"""Layers of the port: thin ``torch.nn.Module``s."""
from . import functional
from .clip import ClipGradByGlobalNorm
from .layer.activation import GELU, Tanh
from .layer.common import Dropout, Embedding, Linear
from .layer.loss import CrossEntropyLoss
from .layer.norm import LayerNorm, RMSNorm
from .layer.transformer import (MultiHeadAttention, TransformerEncoder,
                                TransformerEncoderLayer)

__all__ = ["ClipGradByGlobalNorm", "CrossEntropyLoss", "Dropout",
           "Embedding", "GELU", "LayerNorm", "Linear", "MultiHeadAttention",
           "RMSNorm", "Tanh", "TransformerEncoder", "TransformerEncoderLayer",
           "functional"]
