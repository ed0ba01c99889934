"""Layers of the port: thin ``torch.nn.Module``s."""
from . import functional
from .clip import ClipGradByGlobalNorm
from .layer.activation import GELU, ReLU, Tanh
from .layer.common import Dropout, Embedding, Flatten, Linear
from .layer.conv_pool import (AdaptiveAvgPool2D, AvgPool2D, Conv1D, Conv2D,
                              MaxPool2D)
from .layer.layers import Sequential
from .layer.loss import CrossEntropyLoss
from .layer.norm import (BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D,
                         LayerNorm, RMSNorm)
from .layer.rnn import (GRU, LSTM, RNN, BiRNN, GRUCell, LSTMCell,
                        RNNCellBase, SimpleRNN, SimpleRNNCell)
from .layer.transformer import (MultiHeadAttention, TransformerEncoder,
                                TransformerEncoderLayer)

__all__ = ["AdaptiveAvgPool2D", "AvgPool2D", "BatchNorm", "BatchNorm1D",
           "BatchNorm2D", "BatchNorm3D", "BiRNN", "ClipGradByGlobalNorm",
           "Conv1D", "Conv2D", "CrossEntropyLoss", "Dropout", "Embedding",
           "Flatten", "GELU", "GRU", "GRUCell", "LSTM", "LSTMCell",
           "LayerNorm", "Linear", "MaxPool2D", "MultiHeadAttention", "RNN",
           "RNNCellBase", "RMSNorm", "ReLU", "Sequential", "SimpleRNN",
           "SimpleRNNCell", "Tanh", "TransformerEncoder",
           "TransformerEncoderLayer", "functional"]
