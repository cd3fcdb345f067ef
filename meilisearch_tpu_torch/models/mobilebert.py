"""MobileBERT's encoder forward as a torch module (the port's K8 for
`model_type` `mobilebert`: google/mobilebert-uncased and the models
fine-tuned from it).

It computes what transformers' torch `MobileBertModel` computes, the model
the JAX package's encoder (`models/hf_encoder.py` there) runs through its
torch branch, since transformers has no Flax MobileBERT. It returns the
last hidden state (pooling stays in models/hf_encoder.py):

- embeddings: word embeddings `embedding_size` wide; with `trigram_input`
  each token's embedding is concatenated with the NEXT token's before it
  and the PREVIOUS token's after it (`[x[t + 1], x[t], x[t - 1]]`, zero
  rows past either end), then `embedding_transformation` maps the 3 x
  `embedding_size` to `hidden_size` (it runs whenever `trigram_input` is
  set or the widths differ); plus positions (0..L-1), plus the token-type
  embedding of type 0, then the norm;
- the norm of every block is `normalization_type`'s: `no_norm` is
  `NoNorm`, `x * weight + bias` with no statistics (google/mobilebert-
  uncased), `layer_norm` a LayerNorm. The embeddings' LayerNorm and each
  layer's `output.LayerNorm` take torch's default eps 1e-5, as
  transformers builds them; the others `layer_norm_eps`;
- each layer, with `use_bottleneck`: `bottleneck.input` (dense to
  `intra_bottleneck_size`, norm) gives the layer input; Q and K come from
  `bottleneck.attention` (the shared bottleneck, with
  `key_query_shared_bottleneck`) and V from the full-width hidden state,
  or all three from the layer input (`use_bottleneck_attention`, which
  wins), or all three from the hidden state. Attention `true_hidden_size`
  wide (`intra_bottleneck_size` with the bottleneck, else `hidden_size`):
  scores (Q K^T) / sqrt(d_head), padded keys REPLACED by finfo(float32).min
  (transformers adds the same minimum: the softmax is the same), softmax,
  times V; `attention.output`: dense, then norm(+ the layer input, the
  bottlenecked one). Then `num_feedforward_networks` - 1 stacked FFNs
  (`ffn.{i}`: dense, activation, dense, norm(+ their input)), and the
  last: `intermediate` (dense, activation), `output.dense`, norm(+ its
  input); with the bottleneck, `output.bottleneck` (dense back to
  `hidden_size`, norm(+ the layer's full-width input)).

The activation is `hidden_act` through models/activations.py (`relu` in
google/mobilebert-uncased). Refused by name: a `normalization_type`
transformers does not know, `num_feedforward_networks` under 1, a
`true_hidden_size` that is not a multiple of the heads, and the
bottleneck with neither shared nor bottleneck attention where the hidden
width is not the bottleneck's (transformers raises on each).

The trigram reads the pad's word row beside a text's last real token
when its batch pads it (and zeros when it is the longest): that row is
zero in a trained checkpoint (`nn.Embedding(padding_idx)`, as here), so a
text's vector does not depend on its batch; with a nonzero row it would,
in transformers as here.

Attention is written as explicit products and a softmax, not
`scaled_dot_product_attention`. Parameter names are `MobileBertModel`'s
(`embeddings.embedding_transformation.weight`,
`encoder.layer.{i}.bottleneck.input.dense.weight`,
`encoder.layer.{i}.attention.self.query.weight`,
`encoder.layer.{i}.ffn.{j}.output.LayerNorm.weight`,
`encoder.layer.{i}.output.bottleneck.dense.weight`, ...), so a checkpoint's
tensors load by name (models/checkpoint.py).

Everything runs in float32. On a CUDA device the forward raises when
`torch.backends.cuda.matmul.allow_tf32` is set, as models/bert.py does.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .activations import activation

MODEL_TYPE = "mobilebert"
# MobileBertConfig's defaults, google/mobilebert-uncased's published config
DEFAULTS = {"vocab_size": 30522, "hidden_size": 512, "num_hidden_layers": 24,
            "num_attention_heads": 4, "intermediate_size": 512, "hidden_act": "relu",
            "max_position_embeddings": 512, "type_vocab_size": 2, "layer_norm_eps": 1e-12,
            "pad_token_id": 0, "embedding_size": 128, "trigram_input": True,
            "use_bottleneck": True, "intra_bottleneck_size": 128,
            "use_bottleneck_attention": False, "key_query_shared_bottleneck": True,
            "num_feedforward_networks": 4, "normalization_type": "no_norm"}
NORMS = ("layer_norm", "no_norm")
TORCH_EPS = 1e-5  # nn.LayerNorm's default, where transformers passes no eps


def check_config(config: dict) -> dict:
    """Raise ValueError unless `config` describes a MobileBERT this module
    runs; return it with MobileBertConfig's defaults filled in and
    `true_hidden_size` computed as MobileBertConfig computes it (whatever
    the file says)."""
    config = {**DEFAULTS, **config}
    activation(config["hidden_act"])
    if config["normalization_type"] not in NORMS:
        raise ValueError(f"normalization_type `{config['normalization_type']}` is not supported:"
                         f" transformers' MobileBERT knows {' and '.join(NORMS)}")
    if config["num_feedforward_networks"] < 1:
        raise ValueError("num_feedforward_networks under 1 is not supported: transformers'"
                         " MobileBertLayer raises on it")
    true = config["intra_bottleneck_size"] if config["use_bottleneck"] else config["hidden_size"]
    if true % config["num_attention_heads"]:
        raise ValueError(f"true_hidden_size {true} is not a multiple of num_attention_heads:"
                         " transformers' attention output does not fit its dense layer")
    if (config["use_bottleneck"] and not config["key_query_shared_bottleneck"]
            and not config["use_bottleneck_attention"] and true != config["hidden_size"]):
        raise ValueError("use_bottleneck without key_query_shared_bottleneck or"
                         " use_bottleneck_attention is supported only where hidden_size equals"
                         " intra_bottleneck_size: transformers' attention reads the hidden state"
                         " through layers as wide as the bottleneck, and raises")
    return {**config, "true_hidden_size": true}


class NoNorm(nn.Module):
    """MobileBERT's `NoNorm`: x * weight + bias."""

    def __init__(self, width: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(width))
        self.bias = nn.Parameter(torch.zeros(width))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.weight + self.bias


def _norm(c: dict, width: int, eps: float) -> nn.Module:
    if c["normalization_type"] == "no_norm":
        return NoNorm(width)
    return nn.LayerNorm(width, eps=eps)


class _Embeddings(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        e, h = c["embedding_size"], c["hidden_size"]
        self.trigram = c["trigram_input"]
        self.word_embeddings = nn.Embedding(c["vocab_size"], e, padding_idx=c["pad_token_id"])
        self.position_embeddings = nn.Embedding(c["max_position_embeddings"], h)
        self.token_type_embeddings = nn.Embedding(c["type_vocab_size"], h)
        self.embedding_transformation = nn.Linear(e * (3 if self.trigram else 1), h)
        self.transform = self.trigram or e != h
        self.LayerNorm = _norm(c, h, TORCH_EPS)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        x = self.word_embeddings(input_ids)
        if self.trigram:  # [next, this, previous], zeros past the ends
            x = torch.cat([F.pad(x[:, 1:], [0, 0, 0, 1]), x, F.pad(x[:, :-1], [0, 0, 1, 0])],
                          dim=2)
        if self.transform:
            x = self.embedding_transformation(x)
        x = x + self.position_embeddings.weight[: input_ids.shape[1]]
        return self.LayerNorm(x + self.token_type_embeddings.weight[0])


class _SelfAttention(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        t = c["true_hidden_size"]
        self.heads = c["num_attention_heads"]
        self.query = nn.Linear(t, t)
        self.key = nn.Linear(t, t)
        self.value = nn.Linear(t if c["use_bottleneck_attention"] else c["hidden_size"], t)

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                blocked: torch.Tensor) -> torch.Tensor:
        B, L, _ = q.shape
        t = self.query.out_features
        d = t // self.heads

        def split(x):  # (B, L, t) -> (B, heads, L, d)
            return x.view(B, L, self.heads, d).transpose(1, 2)

        scores = torch.matmul(split(self.query(q)), split(self.key(k)).transpose(-1, -2))
        scores = scores / math.sqrt(d)
        scores.masked_fill_(blocked, torch.finfo(scores.dtype).min)
        probs = torch.softmax(scores, dim=-1)
        return torch.matmul(probs, split(self.value(v))).transpose(1, 2).reshape(B, L, t)


class _DenseNorm(nn.Module):
    """dense, then norm(dense(x) + residual)."""

    def __init__(self, c: dict, n_in: int, n_out: int, eps: float):
        super().__init__()
        self.dense = nn.Linear(n_in, n_out)
        self.LayerNorm = _norm(c, n_out, eps)

    def forward(self, x: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
        return self.LayerNorm(self.dense(x) + residual)


class _Attention(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        t = c["true_hidden_size"]
        self.self = _SelfAttention(c)
        self.output = _DenseNorm(c, t, t, c["layer_norm_eps"])


class _Intermediate(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        self.dense = nn.Linear(c["true_hidden_size"], c["intermediate_size"])
        self.act = activation(c["hidden_act"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.dense(x))


class _FFN(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        self.intermediate = _Intermediate(c)
        self.output = _DenseNorm(c, c["intermediate_size"], c["true_hidden_size"],
                                 c["layer_norm_eps"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.output(self.intermediate(x), x)


class _Output(nn.Module):
    """dense, norm(+ the attention output); with the bottleneck, then
    `bottleneck`: dense back to hidden_size, norm(+ the layer's input)."""

    def __init__(self, c: dict):
        super().__init__()
        t = c["true_hidden_size"]
        self.dense = nn.Linear(c["intermediate_size"], t)
        self.LayerNorm = _norm(c, t, TORCH_EPS)
        if c["use_bottleneck"]:
            self.bottleneck = _DenseNorm(c, t, c["hidden_size"], c["layer_norm_eps"])
        else:
            self.bottleneck = None

    def forward(self, x: torch.Tensor, attention_output: torch.Tensor,
                hidden: torch.Tensor) -> torch.Tensor:
        y = self.LayerNorm(self.dense(x) + attention_output)
        return y if self.bottleneck is None else self.bottleneck(y, hidden)


class _BottleneckLayer(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        self.dense = nn.Linear(c["hidden_size"], c["intra_bottleneck_size"])
        self.LayerNorm = _norm(c, c["intra_bottleneck_size"], c["layer_norm_eps"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.LayerNorm(self.dense(x))


class _Bottleneck(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        self.shared = c["key_query_shared_bottleneck"]
        self.all = c["use_bottleneck_attention"]
        self.input = _BottleneckLayer(c)
        self.attention = _BottleneckLayer(c) if self.shared else None

    def forward(self, hidden: torch.Tensor) -> tuple:
        """(query input, key input, value input, layer input)."""
        layer_input = self.input(hidden)
        if self.all:
            return layer_input, layer_input, layer_input, layer_input
        if self.shared:
            shared = self.attention(hidden)
            return shared, shared, hidden, layer_input
        return hidden, hidden, hidden, layer_input


class _Layer(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        self.attention = _Attention(c)
        self.intermediate = _Intermediate(c)
        self.output = _Output(c)
        self.bottleneck = _Bottleneck(c) if c["use_bottleneck"] else None
        self.ffn = nn.ModuleList(_FFN(c) for _ in range(c["num_feedforward_networks"] - 1))

    def forward(self, hidden: torch.Tensor, blocked: torch.Tensor) -> torch.Tensor:
        if self.bottleneck is None:
            q = k = v = layer_input = hidden
        else:
            q, k, v, layer_input = self.bottleneck(hidden)
        a = self.attention.output(self.attention.self(q, k, v, blocked), layer_input)
        for ffn in self.ffn:
            a = ffn(a)
        return self.output(self.intermediate(a), a, hidden)


class _Encoder(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        self.layer = nn.ModuleList(_Layer(c) for _ in range(c["num_hidden_layers"]))


class MobileBertModel(nn.Module):
    """MobileBERT's encoder stack, widths from a transformers-style config
    dict (MobileBertConfig's names, defaults filled in)."""

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
        blocked = (attention_mask == 0)[:, None, None, :]  # (B, 1, 1, L): padded keys
        for layer in self.encoder.layer:
            x = layer(x, blocked)
        return x
