"""RoFormer's encoder forward as a torch module (the port's K8 for
`model_type` `roformer`: junnyu/roformer_chinese_base and the RoFormer
similarity models).

It computes what transformers' torch `RoFormerModel` computes, the model
the JAX package's encoder (`models/hf_encoder.py` there) runs through its
torch branch (its Flax branch raises on such a directory, fault 3.23). It
returns the last hidden state (pooling stays in models/hf_encoder.py):

- embeddings: word + token type (all zeros), no position embedding, then
  LayerNorm, `embedding_size` wide; `embeddings_project` (a Linear with
  bias) to `hidden_size` when the widths differ;
- positions: `encoder.embed_positions.weight`, a (max_position_embeddings,
  head_dim) sinusoidal table, sin(pos / 10000^(2 (j // 2) / head_dim)) of
  the even columns in the first half and cos of the odd ones in the
  second. A checkpoint that holds it is read; one that does not gets it
  built here on the host as `RoFormerSinusoidalPositionalEmbedding`
  builds it (numpy float64, then float32: `sinusoidal_table`);
- each layer: Q/K/V projections; the rotation, in its INTERLEAVED form
  (not Llama's half split, models/rope.py): sin and cos of row l each
  repeated in pairs, x cos + stack([-x[..., 1::2], x[..., ::2]]) sin, on
  Q and K, and on V with `rotary_value`; scores (Q K^T) / sqrt(d_head),
  padded keys REPLACED by finfo(float32).min (`masked_fill_`, never
  added), softmax, times V, the output projection, residual and
  LayerNorm; the intermediate projection, the activation (`hidden_act`
  through models/activations.py), the output projection, residual and
  LayerNorm, as in BERT.

Attention is written as explicit products and a softmax, not
`scaled_dot_product_attention`. Parameter names are `RoFormerModel`'s
(`embeddings.word_embeddings.weight`, `encoder.embed_positions.weight`,
`encoder.layer.{i}.attention.self.query.weight`, ...), so a checkpoint's
tensors load by name (models/checkpoint.py).

Everything runs in float32. On a CUDA device the forward raises when
`torch.backends.cuda.matmul.allow_tf32` is set, as models/bert.py does.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
from torch import nn

from .activations import activation

MODEL_TYPE = "roformer"
# the widths a config must give (transformers' RoFormerConfig names)
CONFIG_KEYS = ("vocab_size", "hidden_size", "num_hidden_layers", "num_attention_heads",
               "intermediate_size", "max_position_embeddings", "type_vocab_size",
               "layer_norm_eps")
POSITIONS = "encoder.embed_positions.weight"


def check_config(config: dict) -> dict:
    """Raise ValueError unless `config` describes a RoFormer this module
    runs; return it with `embedding_size` (default `hidden_size`),
    `hidden_act` and `rotary_value` (default false)."""
    missing = [k for k in CONFIG_KEYS if k not in config]
    if missing:
        raise ValueError(f"the roformer config lacks {missing}")
    act = config.get("hidden_act", "gelu")
    activation(act)
    if "position_embedding_type" in config:
        raise ValueError("position_embedding_type is not read by RoFormer: the port refuses a"
                         " roformer config that gives one")
    if config["hidden_size"] % config["num_attention_heads"]:
        raise ValueError("hidden_size is not a multiple of num_attention_heads")
    return {**config, "embedding_size": config.get("embedding_size") or config["hidden_size"],
            "hidden_act": act, "rotary_value": bool(config.get("rotary_value", False))}


@lru_cache(maxsize=4)
def sinusoidal_table(n_pos: int, dim: int) -> torch.Tensor:
    """`RoFormerSinusoidalPositionalEmbedding._init_weight`'s (n_pos, dim)
    float32 table, computed as there: each angle pos / 10000^(2 (j // 2)
    / dim) in float64 (the powers one numpy scalar call each), np.sin of
    the even columns and np.cos of the odd ones of the full array."""
    powers = np.array([np.power(10000, 2 * (j // 2) / dim) for j in range(dim)])
    position_enc = np.arange(n_pos, dtype=np.float64)[:, None] / powers[None, :]
    out = torch.empty(n_pos, dim, dtype=torch.float32)
    sentinel = dim // 2 if dim % 2 == 0 else (dim // 2) + 1
    out[:, 0:sentinel] = torch.FloatTensor(np.sin(position_enc[:, 0::2]))
    out[:, sentinel:] = torch.FloatTensor(np.cos(position_enc[:, 1::2]))
    return out


def with_positions(config: dict, state_dict: dict) -> dict:
    """`state_dict` with the sinusoidal table when the checkpoint lacks it."""
    if POSITIONS in state_dict:
        return state_dict
    c = check_config(config)
    dim = c["hidden_size"] // c["num_attention_heads"]
    return {**state_dict, POSITIONS: sinusoidal_table(c["max_position_embeddings"], dim).clone()}


def rotate(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """RoFormer's interleaved rotation of (B, heads, L, d) x by (L, d)
    tables whose entries repeat in pairs."""
    pairs = torch.stack([-x[..., 1::2], x[..., ::2]], dim=-1).reshape_as(x)
    return x * cos + pairs * sin


class _Embeddings(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        e = c["embedding_size"]
        self.word_embeddings = nn.Embedding(c["vocab_size"], e)
        self.token_type_embeddings = nn.Embedding(c["type_vocab_size"], e)
        self.LayerNorm = nn.LayerNorm(e, eps=c["layer_norm_eps"])

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.LayerNorm(self.word_embeddings(input_ids)
                              + self.token_type_embeddings.weight[0])


class _SelfAttention(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        h = c["hidden_size"]
        self.heads = c["num_attention_heads"]
        self.query = nn.Linear(h, h)
        self.key = nn.Linear(h, h)
        self.value = nn.Linear(h, h)
        self.rotary_value = c["rotary_value"]

    def forward(self, x: torch.Tensor, blocked: torch.Tensor, sin: torch.Tensor,
                cos: torch.Tensor) -> torch.Tensor:
        B, L, h = x.shape
        d = h // self.heads

        def split(t):  # (B, L, h) -> (B, heads, L, d)
            return t.view(B, L, self.heads, d).transpose(1, 2)

        q, k, v = split(self.query(x)), split(self.key(x)), split(self.value(x))
        q, k = rotate(q, sin, cos), rotate(k, sin, cos)
        if self.rotary_value:
            v = rotate(v, sin, cos)
        scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(d)
        scores.masked_fill_(blocked, torch.finfo(scores.dtype).min)
        probs = torch.softmax(scores, dim=-1)
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

    def forward(self, x, blocked, sin, cos) -> torch.Tensor:
        return self.output(self.self(x, blocked, sin, cos), x)


class _Intermediate(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        self.dense = nn.Linear(c["hidden_size"], c["intermediate_size"])
        self.act = activation(c["hidden_act"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.dense(x))


class _Layer(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        self.attention = _Attention(c)
        self.intermediate = _Intermediate(c)
        self.output = _Output(c["intermediate_size"], c)

    def forward(self, x, blocked, sin, cos) -> torch.Tensor:
        a = self.attention(x, blocked, sin, cos)
        return self.output(self.intermediate(a), a)


class _Encoder(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        self.embed_positions = nn.Embedding(c["max_position_embeddings"],
                                            c["hidden_size"] // c["num_attention_heads"])
        self.layer = nn.ModuleList(_Layer(c) for _ in range(c["num_hidden_layers"]))


class RoFormerModel(nn.Module):
    """RoFormer's encoder, widths from a transformers-style config dict."""

    def __init__(self, config: dict):
        super().__init__()
        config = check_config(config)
        self.config = config
        self.embeddings = _Embeddings(config)
        if config["embedding_size"] != config["hidden_size"]:
            self.embeddings_project = nn.Linear(config["embedding_size"], config["hidden_size"])
        else:
            self.embeddings_project = None
        self.encoder = _Encoder(config)

    def rotary(self, L: int) -> tuple:
        """(sin, cos), each (L, head_dim) with its entries repeated in
        pairs, from the first L rows of the sinusoidal table."""
        sin, cos = self.encoder.embed_positions.weight[:L].chunk(2, dim=-1)
        return (torch.stack([sin, sin], dim=-1).reshape(L, -1),
                torch.stack([cos, cos], dim=-1).reshape(L, -1))

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        """(B, L) int64 ids and 0/1 mask -> (B, L, hidden) float32, the
        last hidden state."""
        if input_ids.is_cuda and torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError(
                "the text encoder needs full float32 matmuls:"
                " torch.backends.cuda.matmul.allow_tf32 is True"
            )
        x = self.embeddings(input_ids)
        if self.embeddings_project is not None:
            x = self.embeddings_project(x)
        blocked = (attention_mask == 0)[:, None, None, :]  # (B, 1, 1, L): padded keys
        sin, cos = self.rotary(input_ids.shape[1])
        for layer in self.encoder.layer:
            x = layer(x, blocked, sin, cos)
        return x
