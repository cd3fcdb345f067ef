"""ALBERT's encoder forward as a torch module (the port's K8 for
`model_type` `albert`: sentence-transformers/paraphrase-albert-small-v2
and the albert-base/large checkpoints).

It computes what transformers' torch `AlbertModel` computes, the model the
JAX package's encoder (`models/hf_encoder.py` there) runs through its
torch branch (its Flax branch, `FlaxAlbertModel`, agrees with it within
1e-7). It returns the last hidden state (pooling stays in
models/hf_encoder.py):

- factorized embeddings: word + token type (all zeros) + position
  (0..L-1; none with relative keys), `embedding_size` wide, then
  LayerNorm; then `embeddings_project` (`encoder.embedding_hidden_mapping_in`
  in the checkpoint, renamed by models/checkpoint.py as RemBERT's is)
  takes them to `hidden_size`;
- shared layers: `num_hidden_layers` passes, pass i over every one of the
  `inner_group_num` layers of group int(i / (num_hidden_layers /
  num_hidden_groups)), as `AlbertTransformer` computes it; a group's
  weights are held once, however many passes read them;
- each layer: Q/K/V projections, scores (Q K^T) / sqrt(d_head), padded
  keys REPLACED by finfo(float32).min (`masked_fill_`, never added), then,
  for `relative_key` / `relative_key_query`, the distance terms
  (`attention.distance_embedding` gathered at l - r +
  max_position_embeddings - 1: einsum(Q, pos), and einsum(K, pos)),
  added unscaled after the mask as `AlbertAttention` adds them; softmax,
  times V, `attention.dense`, residual and `attention.LayerNorm`; then
  `ffn`, the activation (`hidden_act` through models/activations.py;
  `gelu_new` in the published checkpoints), `ffn_output`, and
  `full_layer_layer_norm` over the FFN output plus the attention output.

Attention is written as explicit products and a softmax, not
`scaled_dot_product_attention`. Parameter names are `AlbertModel`'s
(`embeddings.word_embeddings.weight`,
`encoder.albert_layer_groups.{g}.albert_layers.{j}.attention.query.weight`,
`...ffn.weight`, `...full_layer_layer_norm.weight`), but for the
projection, so a checkpoint's tensors load by name (models/checkpoint.py).

Everything runs in float32. On a CUDA device the forward raises when
`torch.backends.cuda.matmul.allow_tf32` is set, as models/bert.py does.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .activations import activation
from .bert import RELATIVE_KEYS, distance_index, relative_scores

MODEL_TYPE = "albert"
# the widths a config must give (transformers' AlbertConfig names)
CONFIG_KEYS = ("vocab_size", "embedding_size", "hidden_size", "num_hidden_layers",
               "num_hidden_groups", "inner_group_num", "num_attention_heads",
               "intermediate_size", "max_position_embeddings", "type_vocab_size",
               "layer_norm_eps")


def check_config(config: dict) -> dict:
    """Raise ValueError unless `config` describes an ALBERT this module
    runs; return it with `hidden_act` and `position_embedding_type`
    (transformers' defaults: `gelu_new`, `absolute`)."""
    missing = [k for k in CONFIG_KEYS if k not in config]
    if missing:
        raise ValueError(f"the albert config lacks {missing}")
    act = config.get("hidden_act", "gelu_new")
    activation(act)
    positions = config.get("position_embedding_type", "absolute")
    if positions not in ("absolute", *RELATIVE_KEYS):
        raise ValueError(f"position_embedding_type `{positions}` is not supported: the port"
                         f" reads absolute position embeddings and {' and '.join(RELATIVE_KEYS)}")
    if config["hidden_size"] % config["num_attention_heads"]:
        raise ValueError("hidden_size is not a multiple of num_attention_heads")
    if not 0 < config["num_hidden_groups"] <= config["num_hidden_layers"]:
        raise ValueError(f"num_hidden_groups {config['num_hidden_groups']} is not between 1 and"
                         f" num_hidden_layers {config['num_hidden_layers']}")
    # AlbertTransformer hands each group the head-mask slice of
    # int(layers / groups) entries from group * that, and indexes it per
    # inner layer: transformers raises where a slice is shorter
    n, per = config["num_hidden_layers"], int(config["num_hidden_layers"]
                                             / config["num_hidden_groups"])
    if any(len(range(n)[group_of(config, i) * per:(group_of(config, i) + 1) * per])
           < config["inner_group_num"] for i in range(n)):
        raise ValueError(f"inner_group_num {config['inner_group_num']} is more than a group's"
                         f" share of {n} layers over {config['num_hidden_groups']} groups:"
                         " transformers' AlbertTransformer raises on it")
    return {**config, "hidden_act": act, "position_embedding_type": positions}


def group_of(config: dict, i: int) -> int:
    """The group that pass i runs, as `AlbertTransformer` computes it."""
    return int(i / (config["num_hidden_layers"] / config["num_hidden_groups"]))


class _Embeddings(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        e = c["embedding_size"]
        self.word_embeddings = nn.Embedding(c["vocab_size"], e)
        self.position_embeddings = nn.Embedding(c["max_position_embeddings"], e)
        self.token_type_embeddings = nn.Embedding(c["type_vocab_size"], e)
        self.LayerNorm = nn.LayerNorm(e, eps=c["layer_norm_eps"])
        self.absolute = c["position_embedding_type"] == "absolute"

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        x = self.word_embeddings(input_ids) + self.token_type_embeddings.weight[0]
        if self.absolute:
            x = x + self.position_embeddings.weight[:input_ids.shape[1]]
        return self.LayerNorm(x)


class _Attention(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        h = c["hidden_size"]
        self.heads = c["num_attention_heads"]
        self.query = nn.Linear(h, h)
        self.key = nn.Linear(h, h)
        self.value = nn.Linear(h, h)
        self.dense = nn.Linear(h, h)
        self.LayerNorm = nn.LayerNorm(h, eps=c["layer_norm_eps"])
        self.relative = c["position_embedding_type"]
        if self.relative in RELATIVE_KEYS:
            self.distance_embedding = nn.Embedding(2 * c["max_position_embeddings"] - 1,
                                                   h // self.heads)
        else:
            self.distance_embedding = None

    def forward(self, x: torch.Tensor, blocked: torch.Tensor, distance) -> torch.Tensor:
        B, L, h = x.shape
        d = h // self.heads

        def split(t):  # (B, L, h) -> (B, heads, L, d)
            return t.view(B, L, self.heads, d).transpose(1, 2)

        q, k, v = split(self.query(x)), split(self.key(x)), split(self.value(x))
        scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(d)
        scores.masked_fill_(blocked, torch.finfo(scores.dtype).min)
        if self.distance_embedding is not None:
            scores = relative_scores(scores, q, k, self.distance_embedding(distance),
                                     self.relative)
        probs = torch.softmax(scores, dim=-1)
        ctx = torch.matmul(probs, v).transpose(1, 2).reshape(B, L, h)
        return self.LayerNorm(x + self.dense(ctx))


class _Layer(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        self.full_layer_layer_norm = nn.LayerNorm(c["hidden_size"], eps=c["layer_norm_eps"])
        self.attention = _Attention(c)
        self.ffn = nn.Linear(c["hidden_size"], c["intermediate_size"])
        self.ffn_output = nn.Linear(c["intermediate_size"], c["hidden_size"])
        self.act = activation(c["hidden_act"])

    def forward(self, x: torch.Tensor, blocked: torch.Tensor, distance) -> torch.Tensor:
        a = self.attention(x, blocked, distance)
        return self.full_layer_layer_norm(self.ffn_output(self.act(self.ffn(a))) + a)


class _Group(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        self.albert_layers = nn.ModuleList(_Layer(c) for _ in range(c["inner_group_num"]))


class _Encoder(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        self.albert_layer_groups = nn.ModuleList(_Group(c) for _ in range(c["num_hidden_groups"]))


class AlbertModel(nn.Module):
    """ALBERT's encoder, widths from a transformers-style config dict."""

    def __init__(self, config: dict):
        super().__init__()
        config = check_config(config)
        self.config = config
        self.embeddings = _Embeddings(config)
        self.embeddings_project = nn.Linear(config["embedding_size"], config["hidden_size"])
        self.encoder = _Encoder(config)

    def passes(self) -> list:
        """The layers in the order a forward runs them, shared ones
        repeated."""
        groups = self.encoder.albert_layer_groups
        return [layer for i in range(self.config["num_hidden_layers"])
                for layer in groups[group_of(self.config, i)].albert_layers]

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        """(B, L) int64 ids and 0/1 mask -> (B, L, hidden) float32, the
        last hidden state."""
        if input_ids.is_cuda and torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError(
                "the text encoder needs full float32 matmuls:"
                " torch.backends.cuda.matmul.allow_tf32 is True"
            )
        x = self.embeddings_project(self.embeddings(input_ids))
        blocked = (attention_mask == 0)[:, None, None, :]  # (B, 1, 1, L): padded keys
        distance = None
        if self.config["position_embedding_type"] in RELATIVE_KEYS:
            L = input_ids.shape[1]
            distance = distance_index(L, self.config["max_position_embeddings"]).to(x.device)
        for layer in self.passes():
            x = layer(x, blocked, distance)
        return x
