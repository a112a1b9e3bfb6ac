"""BERT/ERNIE-style encoder for pretraining (port of
``paddle_tpu/models/bert.py``): built on the paddle-style surface —
``nn.TransformerEncoder`` whose attention takes the flash kernels K1–K3
on CUDA, ``fleet.recompute`` over the encoder layers, the MLM head tied
to the word embeddings (``"mlm_logits"``) and the NSP head.
"""

from __future__ import annotations

import torch

from ..core.dispatch import apply_op
from ..core.tensor import Tensor
from ..distributed.fleet.recompute import recompute
from ..nn import (Dropout, Embedding, GELU, LayerNorm, Linear, Tanh,
                  TransformerEncoder, TransformerEncoderLayer)
from ..nn.functional.loss import cross_entropy
from ..nn.layer.layers import Layer
from ..tensor.creation import zeros_like


def _t(x):
    return x if isinstance(x, Tensor) else Tensor(x)


class BertConfig:
    def __init__(self, vocab_size=30522, hidden_size=768,
                 num_hidden_layers=12, num_attention_heads=12,
                 intermediate_size=3072, hidden_act="gelu",
                 hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1,
                 max_position_embeddings=512, type_vocab_size=2,
                 initializer_range=0.02, layer_norm_eps=1e-12,
                 recompute=False):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.intermediate_size = intermediate_size
        self.hidden_act = hidden_act
        self.hidden_dropout_prob = hidden_dropout_prob
        self.attention_probs_dropout_prob = attention_probs_dropout_prob
        self.max_position_embeddings = max_position_embeddings
        self.type_vocab_size = type_vocab_size
        self.initializer_range = initializer_range
        self.layer_norm_eps = layer_norm_eps
        self.recompute = recompute

    @staticmethod
    def bert_base(**kw):
        return BertConfig(**kw)

    @staticmethod
    def bert_large(**kw):
        """24 layers, hidden 1024, 16 heads of 64, intermediate 4096
        (Devlin et al. 2018, BERT-LARGE); ``kw`` overrides any of them
        (the JAX one raises a ``TypeError`` for those four)."""
        return BertConfig(**{"hidden_size": 1024, "num_hidden_layers": 24,
                             "num_attention_heads": 16,
                             "intermediate_size": 4096, **kw})


class BertEmbeddings(Layer):
    def __init__(self, c: BertConfig):
        super().__init__()
        self.word_embeddings = Embedding(c.vocab_size, c.hidden_size)
        self.position_embeddings = Embedding(c.max_position_embeddings,
                                             c.hidden_size)
        self.token_type_embeddings = Embedding(c.type_vocab_size,
                                               c.hidden_size)
        self.layer_norm = LayerNorm(c.hidden_size, c.layer_norm_eps)
        self.dropout = Dropout(c.hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        input_ids = _t(input_ids)
        ids = input_ids._data
        if position_ids is None:
            position_ids = Tensor._wrap(torch.arange(
                ids.shape[1], device=ids.device).expand(ids.shape))
        if token_type_ids is None:
            token_type_ids = zeros_like(input_ids)
        emb = (self.word_embeddings(input_ids)
               + self.position_embeddings(position_ids)
               + self.token_type_embeddings(token_type_ids))
        return self.dropout(self.layer_norm(emb))


class BertPooler(Layer):
    def __init__(self, c: BertConfig):
        super().__init__()
        self.dense = Linear(c.hidden_size, c.hidden_size)
        self.activation = Tanh()

    def forward(self, hidden_states):
        return self.activation(self.dense(hidden_states[:, 0]))


class BertModel(Layer):
    def __init__(self, config: BertConfig):
        super().__init__()
        self.config = config
        self.embeddings = BertEmbeddings(config)
        enc_layer = TransformerEncoderLayer(
            config.hidden_size, config.num_attention_heads,
            config.intermediate_size, config.hidden_dropout_prob,
            config.hidden_act,
            attn_dropout=config.attention_probs_dropout_prob,
            layer_norm_eps=config.layer_norm_eps)
        self.encoder = TransformerEncoder(enc_layer,
                                          config.num_hidden_layers)
        self.pooler = BertPooler(config)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        emb = self.embeddings(input_ids, token_type_ids, position_ids)
        if self.config.recompute and self.training:
            out = emb
            for lay in self.encoder.layers:
                out = recompute(lay, out, attention_mask)
            if self.encoder.norm is not None:
                out = self.encoder.norm(out)
        else:
            out = self.encoder(emb, attention_mask)
        return out, self.pooler(out)


class BertForPretraining(Layer):
    """MLM + NSP heads; the MLM decoder is tied to the word
    embeddings."""

    def __init__(self, config: BertConfig):
        super().__init__()
        self.bert = BertModel(config)
        c = config
        self.transform = Linear(c.hidden_size, c.hidden_size)
        self.act = GELU()
        self.transform_norm = LayerNorm(c.hidden_size, c.layer_norm_eps)
        self.seq_relationship = Linear(c.hidden_size, 2)
        self.config = config

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        seq_out, pooled = self.bert(input_ids, token_type_ids,
                                    attention_mask=attention_mask)
        h = self.transform_norm(self.act(self.transform(seq_out)))
        wte = self.bert.embeddings.word_embeddings.weight
        logits = apply_op("mlm_logits",
                          lambda a, w: torch.matmul(a, w.t()), h, wte)
        return logits, self.seq_relationship(pooled)


class BertPretrainingCriterion(Layer):
    """Mean MLM cross entropy over the labelled positions (label -100 is
    ignored), plus the NSP cross entropy when its labels are given."""

    def __init__(self, vocab_size=None):
        super().__init__()

    def forward(self, prediction_scores, seq_relationship_score,
                masked_lm_labels, next_sentence_labels=None,
                masked_lm_scale=1.0):
        mlm = cross_entropy(prediction_scores, masked_lm_labels,
                            reduction="mean", ignore_index=-100)
        if next_sentence_labels is not None:
            return mlm + cross_entropy(seq_relationship_score,
                                       next_sentence_labels,
                                       reduction="mean")
        return mlm


__all__ = ["BertConfig", "BertEmbeddings", "BertForPretraining",
           "BertModel", "BertPooler", "BertPretrainingCriterion"]
