"""Layers of the port: thin ``torch.nn.Module``s."""
from . import functional
from .clip import ClipGradByGlobalNorm
from .layer.activation import (GELU, Hardsigmoid, Hardswish, ReLU, ReLU6,
                               Swish, Tanh)
from .layer.common import Dropout, Embedding, Flatten, Linear
from .layer.conv_pool import (AdaptiveAvgPool2D, AvgPool2D, Conv1D, Conv2D,
                              MaxPool2D)
from .layer.layers import LayerList, Sequential
from .layer.loss import CrossEntropyLoss
from .layer.norm import (BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D,
                         LayerNorm, RMSNorm)
from .layer.rnn import (GRU, LSTM, RNN, BiRNN, GRUCell, LSTMCell,
                        RNNCellBase, SimpleRNN, SimpleRNNCell)
from .layer.transformer import (MultiHeadAttention, Transformer,
                                TransformerDecoder, TransformerDecoderLayer,
                                TransformerEncoder, TransformerEncoderLayer)
from .decode import BeamSearchDecoder, Decoder, dynamic_decode

__all__ = ["AdaptiveAvgPool2D", "AvgPool2D", "BatchNorm", "BatchNorm1D",
           "BatchNorm2D", "BatchNorm3D", "BeamSearchDecoder", "BiRNN",
           "ClipGradByGlobalNorm", "Conv1D", "Conv2D", "CrossEntropyLoss",
           "Decoder", "Dropout", "Embedding",
           "Flatten", "GELU", "GRU", "GRUCell", "Hardsigmoid", "Hardswish",
           "LSTM", "LSTMCell", "LayerList", "LayerNorm", "Linear",
           "MaxPool2D", "MultiHeadAttention", "RNN", "RNNCellBase",
           "RMSNorm", "ReLU", "ReLU6", "Sequential", "SimpleRNN",
           "SimpleRNNCell", "Swish", "Tanh", "Transformer",
           "TransformerDecoder", "TransformerDecoderLayer",
           "TransformerEncoder", "TransformerEncoderLayer",
           "dynamic_decode", "functional"]
