"""BERT (port of paddle_tpu/models/bert.py): ``BertConfig``,
``bert_base``, ``bert_tiny``, the embeddings, the pooler, ``BertModel``,
``BertForSequenceClassification`` and ``BertForMaskedLM``.

The encoder is ``nn.layer.transformer.TransformerEncoder``: without an
``attention_mask`` its attention runs the port's flash kernels on the
card (non-causal, forward and backward), with one it is the plain masked
softmax, as in the JAX package.  Weights are drawn on ``device`` from
``seed`` (the JAX initializers' laws: N(0, initializer_range) for the
embeddings and the pooler, classifier and MLM Linears, Xavier normal for
the encoder's Linears, zero biases, unit LayerNorm weights);
``seed=None`` leaves them for a caller that loads them
(``models.convert.bert_params_from_numpy``).  Every Dropout draws from
the model's own ``generator`` on its device, seeded from ``seed`` too,
which a graphed ``jit.TrainStep`` registers with its captures.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from .. import amp
from .._device import resolve_device
from ..nn import functional as F
from ..nn.layer.activation import Tanh
from ..nn.layer.common import Dropout, Embedding, Linear
from ..nn.layer.norm import LayerNorm
from ..nn.layer.transformer import (TransformerEncoder,
                                    TransformerEncoderLayer, add,
                                    xavier_normal_)


@dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-12
    num_labels: int = 2


def bert_base():
    return BertConfig()


def bert_tiny():
    return BertConfig(vocab_size=1000, hidden_size=128, num_hidden_layers=2,
                      num_attention_heads=2, intermediate_size=512,
                      max_position_embeddings=128)


class BertEmbeddings(nn.Module):
    def __init__(self, c: BertConfig, device=None, dtype=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.word_embeddings = Embedding(c.vocab_size, c.hidden_size, **kw)
        self.position_embeddings = Embedding(c.max_position_embeddings,
                                             c.hidden_size, **kw)
        self.token_type_embeddings = Embedding(c.type_vocab_size,
                                               c.hidden_size, **kw)
        self.layer_norm = LayerNorm(c.hidden_size, epsilon=c.layer_norm_eps,
                                    **kw)
        self.dropout = Dropout(c.hidden_dropout_prob, generator=generator)

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        s = input_ids.shape[1]
        if position_ids is None:
            position_ids = torch.arange(s, dtype=torch.int32,
                                        device=input_ids.device)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        emb = add(add(self.word_embeddings(input_ids),
                      self.position_embeddings(position_ids)),
                  self.token_type_embeddings(token_type_ids))
        return self.dropout(self.layer_norm(emb))


class BertPooler(nn.Module):
    def __init__(self, c: BertConfig, device=None, dtype=None):
        super().__init__()
        self.dense = Linear(c.hidden_size, c.hidden_size, bias=True,
                            device=device, dtype=dtype)
        self.activation = Tanh()

    def forward(self, hidden):
        return self.activation(self.dense(_first_token(hidden)))


def _first_token(hidden):
    """``hidden[:, 0]`` (the JAX op ``getitem``, cast under amp O2)."""
    (hidden,) = amp._cast_args("getitem", hidden)
    return hidden[:, 0]


def _additive_mask(attention_mask):
    """(b, 1, 1, s): 0 where ``attention_mask`` (b, s) is 1, -1e9 where it
    is 0 (the JAX ops ``rsub`` and ``multiply``, cast under amp O2)."""
    (m,) = amp._cast_args("rsub", attention_mask.float())
    (m,) = amp._cast_args("multiply", 1.0 - m)
    m = m * -1e9
    return m.reshape(m.shape[0], 1, 1, m.shape[1])


class BertModel(nn.Module):
    """Embeddings, the encoder and the pooler; returns (sequence output,
    pooled output)."""

    def __init__(self, config: Optional[BertConfig] = None, device=None,
                 dtype=None, generator=None):
        super().__init__()
        c = config or BertConfig()
        self.config = c
        kw = dict(device=device, dtype=dtype)
        self.embeddings = BertEmbeddings(c, generator=generator, **kw)
        enc_layer = TransformerEncoderLayer(
            c.hidden_size, c.num_attention_heads, c.intermediate_size,
            dropout=c.hidden_dropout_prob, activation=c.hidden_act,
            attn_dropout=c.attention_probs_dropout_prob,
            layer_norm_eps=c.layer_norm_eps, generator=generator, **kw)
        self.encoder = TransformerEncoder(enc_layer, c.num_hidden_layers)
        self.pooler = BertPooler(c, **kw)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                position_ids=None):
        emb = self.embeddings(input_ids, token_type_ids, position_ids)
        mask = None if attention_mask is None \
            else _additive_mask(attention_mask)
        encoded = self.encoder(emb, mask)
        return encoded, self.pooler(encoded)


class _Seeded(nn.Module):
    """What the task heads share: the device, the dropout generator and
    the seeded init."""

    def _setup(self, config, device, dtype, seed):
        c = self.config = config or BertConfig()
        device = resolve_device(device)
        self.generator = torch.Generator(device=device)
        self.generator.manual_seed(0 if seed is None else int(seed) + 1)
        return c, dict(device=device, dtype=dtype)

    @torch.no_grad()
    def init_weights(self, seed: int) -> None:
        """Draw every weight with one generator on the model's device
        seeded by ``seed``, module by module in order."""
        c = self.config
        gen = torch.Generator(device=self.generator.device)
        gen.manual_seed(int(seed))
        encoder = {id(m) for m in self.bert.encoder.modules()}
        for module in self.modules():
            if isinstance(module, Embedding):
                module.weight.normal_(0.0, c.initializer_range, generator=gen)
            elif isinstance(module, Linear):
                if id(module) in encoder:
                    xavier_normal_(module.weight, gen)
                else:
                    module.weight.normal_(0.0, c.initializer_range,
                                          generator=gen)
                if module.bias is not None:
                    module.bias.zero_()
            elif isinstance(module, LayerNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()


class BertForSequenceClassification(_Seeded):
    """BERT, dropout and a Linear over the pooled output: logits (b,
    num_labels); with ``labels``, ``(loss, logits)``."""

    def __init__(self, config: Optional[BertConfig] = None, device="cuda",
                 dtype=None, seed: Optional[int] = 0):
        super().__init__()
        c, kw = self._setup(config, device, dtype, seed)
        self.bert = BertModel(c, generator=self.generator, **kw)
        self.dropout = Dropout(c.hidden_dropout_prob,
                               generator=self.generator)
        self.classifier = Linear(c.hidden_size, c.num_labels, bias=True,
                                 **kw)
        if seed is not None:
            self.init_weights(seed)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                labels=None):
        _, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        logits = self.classifier(self.dropout(pooled))
        if labels is not None:
            return F.cross_entropy(logits, labels), logits
        return logits


class BertForMaskedLM(_Seeded):
    """BERT and the MLM head (Linear, gelu, LayerNorm, the vocabulary
    Linear): logits (b, s, vocab); with ``labels`` (-100 ignored),
    ``(loss, logits)``."""

    def __init__(self, config: Optional[BertConfig] = None, device="cuda",
                 dtype=None, seed: Optional[int] = 0):
        super().__init__()
        c, kw = self._setup(config, device, dtype, seed)
        self.bert = BertModel(c, generator=self.generator, **kw)
        self.transform = Linear(c.hidden_size, c.hidden_size, bias=True,
                                **kw)
        self.layer_norm = LayerNorm(c.hidden_size, epsilon=c.layer_norm_eps,
                                    **kw)
        self.decoder = Linear(c.hidden_size, c.vocab_size, bias=True, **kw)
        if seed is not None:
            self.init_weights(seed)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                labels=None):
        encoded, _ = self.bert(input_ids, token_type_ids, attention_mask)
        h = self.layer_norm(F.gelu(self.transform(encoded)))
        logits = self.decoder(h)
        if labels is not None:
            loss = F.cross_entropy(logits.reshape(-1, self.config.vocab_size),
                                   labels.reshape(-1), ignore_index=-100)
            return loss, logits
        return logits
