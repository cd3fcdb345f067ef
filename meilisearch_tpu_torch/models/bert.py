"""BERT's encoder forward as a torch module (the port's K8), for the
BERT, RoBERTa, XLM-RoBERTa and DistilBERT checkpoints (`model_type`
`bert`, `roberta`, `xlm-roberta`, `distilbert`), which share one
architecture.

For BERT it computes what transformers' `FlaxBertModel` computes when the
JAX package's encoder (`models/hf_encoder.py` there) applies it under
`jax.jit`; for the RoBERTa family, what transformers' torch
`XLMRobertaModel` computes (the JAX package's branch for torch weights);
for DistilBERT, what `FlaxDistilBertModel` and the torch
`DistilBertModel` compute (a DistilBERT config's `dim`, `n_layers`,
`n_heads` and `hidden_dim` are read as BERT's widths, and its weights
load under BERT's names, models/checkpoint.py).
It returns the last hidden state (the encoder reads no pooler):

- embeddings: word + token type (all zeros) + position, then LayerNorm
  (`layer_norm_eps`); dropout is off. BERT's positions are 0..L-1. The
  RoBERTa family's count from `pad_token_id` + 1 over the tokens that are
  not the pad id, and a pad token takes position `pad_token_id`
  (transformers' `create_position_ids_from_input_ids`). DistilBERT has no
  token-type embedding: word + position (0..L-1), LayerNorm eps 1e-12;
- each layer: Q/K/V projections, scores (Q / sqrt(d_head)) K^T plus an
  additive bias of finfo(float32).min on padded keys, softmax, times V,
  the output projection, residual and LayerNorm; then the intermediate
  projection, exact (erf) GELU, the output projection, residual and
  LayerNorm.

Attention is written as explicit products and a softmax, the same math
as `FlaxBertSelfAttention`, not `scaled_dot_product_attention`, which
picks its own kernels and rounding. The module's parameter names are
those of transformers' torch `BertModel` (`embeddings.word_embeddings.
weight`, `encoder.layer.{i}.attention.self.query.weight`, ...), so a
checkpoint's tensors load by name (models/checkpoint.py).

Everything runs in float32. On a CUDA device the forward raises when
`torch.backends.cuda.matmul.allow_tf32` is set (TF32 keeps about three
digits), as the vector float leg does (vector/store.py::_cos_column).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

# the widths a config must give (transformers' BertConfig names)
CONFIG_KEYS = (
    "vocab_size",
    "hidden_size",
    "num_hidden_layers",
    "num_attention_heads",
    "intermediate_size",
    "max_position_embeddings",
    "type_vocab_size",
    "layer_norm_eps",
)
# model types whose positions count from the padding id
ROBERTA_TYPES = ("roberta", "xlm-roberta")
MODEL_TYPES = ("bert", *ROBERTA_TYPES, "distilbert")
# a DistilBERT config's widths (transformers' DistilBertConfig names)
DISTILBERT_KEYS = ("vocab_size", "dim", "n_layers", "n_heads", "hidden_dim", "activation",
                   "max_position_embeddings")


def _distilbert_config(config: dict) -> dict:
    missing = [k for k in DISTILBERT_KEYS if k not in config]
    if missing:
        raise ValueError(f"the distilbert config lacks {missing}")
    if config["activation"] != "gelu":
        raise ValueError(
            f"activation `{config['activation']}` is not supported: the port runs exact GELU only"
        )
    if config.get("sinusoidal_pos_embds"):
        raise ValueError("sinusoidal_pos_embds: true is not supported: the port reads learned"
                         " position embeddings only")
    if config["dim"] % config["n_heads"]:
        raise ValueError("dim is not a multiple of n_heads")
    return {**config, "hidden_size": config["dim"], "num_hidden_layers": config["n_layers"],
            "num_attention_heads": config["n_heads"], "intermediate_size": config["hidden_dim"],
            "type_vocab_size": 0, "layer_norm_eps": 1e-12}


def check_config(config: dict) -> dict:
    """Raise ValueError unless `config` describes a model this module runs;
    return it with BERT's width names (CONFIG_KEYS; a DistilBERT config's
    widths renamed, `type_vocab_size` 0: no token-type embedding)."""
    model_type = config.get("model_type", "bert")
    if model_type not in MODEL_TYPES:
        raise ValueError(
            f"model_type `{model_type}` is not supported: the port runs BERT,"
            " RoBERTa, XLM-RoBERTa and DistilBERT checkpoints only"
        )
    if model_type == "distilbert":
        return _distilbert_config(config)
    if model_type in ROBERTA_TYPES and config.get("pad_token_id") is None:
        raise ValueError(f"a `{model_type}` config must give pad_token_id")
    act = config.get("hidden_act", "gelu")
    if act != "gelu":
        raise ValueError(
            f"hidden_act `{act}` is not supported: the port runs exact GELU only"
        )
    missing = [k for k in CONFIG_KEYS if k not in config]
    if missing:
        raise ValueError(f"the model config lacks {missing}")
    if config["hidden_size"] % config["num_attention_heads"]:
        raise ValueError("hidden_size is not a multiple of num_attention_heads")
    return dict(config)


class _Embeddings(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        h = c["hidden_size"]
        self.word_embeddings = nn.Embedding(c["vocab_size"], h)
        self.position_embeddings = nn.Embedding(c["max_position_embeddings"], h)
        if c["type_vocab_size"]:
            self.token_type_embeddings = nn.Embedding(c["type_vocab_size"], h)
        else:  # DistilBERT
            self.token_type_embeddings = None
        self.LayerNorm = nn.LayerNorm(h, eps=c["layer_norm_eps"])
        roberta = c.get("model_type", "bert") in ROBERTA_TYPES
        self.padding_idx = c["pad_token_id"] if roberta else None

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        L = input_ids.shape[1]
        # Flax's order: (words + token types) + positions
        x = self.word_embeddings(input_ids)
        if self.token_type_embeddings is not None:
            x = x + self.token_type_embeddings.weight[0]
        if self.padding_idx is None:
            return self.LayerNorm(x + self.position_embeddings.weight[:L])
        real = (input_ids != self.padding_idx).long()
        positions = torch.cumsum(real, dim=1) * real + self.padding_idx
        return self.LayerNorm(x + self.position_embeddings(positions))


class _SelfAttention(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        h = c["hidden_size"]
        self.heads = c["num_attention_heads"]
        self.query = nn.Linear(h, h)
        self.key = nn.Linear(h, h)
        self.value = nn.Linear(h, h)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        B, L, h = x.shape
        d = h // self.heads

        def split(t):  # (B, L, h) -> (B, heads, L, d)
            return t.view(B, L, self.heads, d).transpose(1, 2)

        q = split(self.query(x)) / math.sqrt(d)
        k, v = split(self.key(x)), split(self.value(x))
        probs = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) + bias, dim=-1)
        return torch.matmul(probs, v).transpose(1, 2).reshape(B, L, h)


class _Output(nn.Module):
    """dense, then LayerNorm(dense(x) + residual)."""

    def __init__(self, n_in: int, c: dict):
        super().__init__()
        self.dense = nn.Linear(n_in, c["hidden_size"])
        self.LayerNorm = nn.LayerNorm(c["hidden_size"], eps=c["layer_norm_eps"])

    def forward(self, x: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
        return self.LayerNorm(self.dense(x) + residual)


class _Attention(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        self.self = _SelfAttention(c)
        self.output = _Output(c["hidden_size"], c)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        return self.output(self.self(x, bias), x)


class _Intermediate(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        self.dense = nn.Linear(c["hidden_size"], c["intermediate_size"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.gelu(self.dense(x))  # exact (erf) GELU


class _Layer(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        self.attention = _Attention(c)
        self.intermediate = _Intermediate(c)
        self.output = _Output(c["intermediate_size"], c)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        a = self.attention(x, bias)
        return self.output(self.intermediate(a), a)


class _Encoder(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        self.layer = nn.ModuleList(_Layer(c) for _ in range(c["num_hidden_layers"]))


class BertModel(nn.Module):
    """BERT's encoder stack, widths from a transformers-style config dict
    (the RoBERTa family's positions, or DistilBERT's layout, when
    `model_type` names it); `config` holds BERT's width names."""

    def __init__(self, config: dict):
        super().__init__()
        config = check_config(config)
        self.config = config
        self.embeddings = _Embeddings(config)
        self.encoder = _Encoder(config)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        """(B, L) int64 ids and 0/1 mask -> (B, L, hidden) float32, the
        last hidden state."""
        if input_ids.is_cuda and torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError(
                "the text encoder needs full float32 matmuls:"
                " torch.backends.cuda.matmul.allow_tf32 is True"
            )
        x = self.embeddings(input_ids)
        # (B, 1, 1, L): 0 on real keys, float32's lowest on padded ones
        bias = torch.where(
            attention_mask[:, None, None, :] > 0,
            torch.zeros((), dtype=x.dtype, device=x.device),
            torch.full((), torch.finfo(x.dtype).min, dtype=x.dtype, device=x.device),
        )
        for layer in self.encoder.layer:
            x = layer(x, bias)
        return x
