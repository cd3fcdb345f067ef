"""SqueezeBERT's encoder forward as a torch module (the port's K8 for
`model_type` `squeezebert`: squeezebert/squeezebert-uncased and the models
fine-tuned from it).

It computes what transformers' torch `SqueezeBertModel` computes, the
model the JAX package's encoder (`models/hf_encoder.py` there) runs
through its torch branch, since transformers has no Flax SqueezeBERT. It
returns the last hidden state (pooling stays in models/hf_encoder.py):

- embeddings: BERT's, word + position (0..L-1) + the token-type embedding
  of type 0, then LayerNorm (`layer_norm_eps`); `embedding_size` must
  equal `hidden_size`, as transformers asserts;
- then the layers in NCW layout (batch, channels, positions): Q, K and V
  are 1 x 1 `Conv1d`s grouped `q_groups`, `k_groups` and `v_groups`;
  scores (Q K^T) / sqrt(d_head), padded keys REPLACED by finfo(float32).min
  (transformers adds the same minimum: the softmax is the same), softmax,
  times V; `post_attention`: a 1 x 1 conv grouped `post_attention_groups`,
  plus the layer input, LayerNorm over the channels; `intermediate`: a
  conv grouped `intermediate_groups` and the activation (`hidden_act`
  through models/activations.py); `output`: a conv grouped
  `output_groups`, plus the post-attention output, LayerNorm over the
  channels. These two LayerNorms take eps 1e-12 whatever the config says,
  as transformers builds `SqueezeBertLayerNorm`.

A grouped convolution is a block-diagonal product: group g's outputs read
group g's inputs only (models/conv.py computes it as a grouped float32
product, not through cuDNN, whose convolutions take TF32 by default).
Refused by name: `embedding_size` other than `hidden_size`, and a group
count that does not divide its convolution's channels (torch's `Conv1d`
raises on it).

Parameter names are `SqueezeBertModel`'s, `Conv1d`'s (out, in / groups, 1)
weights included (`encoder.layers.{i}.attention.query.weight`,
`encoder.layers.{i}.post_attention.conv1d.weight`,
`encoder.layers.{i}.post_attention.layernorm.weight`,
`encoder.layers.{i}.intermediate.conv1d.weight`,
`encoder.layers.{i}.output.conv1d.weight`, ...), so a checkpoint's tensors
load by name (models/checkpoint.py drops the `transformer.` prefix).

Everything runs in float32. On a CUDA device the forward raises when
`torch.backends.cuda.matmul.allow_tf32` is set, as models/bert.py does.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .activations import activation
from .conv import Conv1d

MODEL_TYPE = "squeezebert"
# SqueezeBertConfig's defaults, squeezebert-uncased's published config
DEFAULTS = {"vocab_size": 30522, "hidden_size": 768, "num_hidden_layers": 12,
            "num_attention_heads": 12, "intermediate_size": 3072, "hidden_act": "gelu",
            "max_position_embeddings": 512, "type_vocab_size": 2, "layer_norm_eps": 1e-12,
            "pad_token_id": 0, "embedding_size": 768, "q_groups": 4, "k_groups": 4,
            "v_groups": 4, "post_attention_groups": 1, "intermediate_groups": 4,
            "output_groups": 4}
CHANNEL_EPS = 1e-12  # SqueezeBertLayerNorm's, whatever layer_norm_eps says


def check_config(config: dict) -> dict:
    """Raise ValueError unless `config` describes a SqueezeBERT this module
    runs; return it with SqueezeBertConfig's defaults filled in."""
    config = {**DEFAULTS, **config}
    h, inter = config["hidden_size"], config["intermediate_size"]
    if config["embedding_size"] != h:
        raise ValueError(f"embedding_size {config['embedding_size']} is not hidden_size {h}:"
                         " transformers' SqueezeBertEncoder asserts they are equal")
    if h % config["num_attention_heads"]:
        raise ValueError("hidden_size is not a multiple of num_attention_heads")
    activation(config["hidden_act"])
    for key, channels in (("q_groups", (h,)), ("k_groups", (h,)), ("v_groups", (h,)),
                          ("post_attention_groups", (h,)), ("intermediate_groups", (h, inter)),
                          ("output_groups", (inter, h))):
        if any(n % config[key] for n in channels):
            raise ValueError(f"{key} {config[key]} does not divide the channels {channels}:"
                             " torch's Conv1d raises on it")
    return config


def _conv(n_in: int, n_out: int, groups: int) -> Conv1d:
    return Conv1d(n_in, n_out, kernel_size=1, groups=groups)


class _ChannelNorm(nn.LayerNorm):
    """LayerNorm over the channels of an NCW tensor."""

    def __init__(self, width: int):
        super().__init__(width, eps=CHANNEL_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.permute(0, 2, 1)).permute(0, 2, 1)


class _ConvNorm(nn.Module):
    """conv1d, plus the residual, LayerNorm over the channels."""

    def __init__(self, n_in: int, n_out: int, groups: int):
        super().__init__()
        self.conv1d = _conv(n_in, n_out, groups)
        self.layernorm = _ChannelNorm(n_out)

    def forward(self, x: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
        return self.layernorm(self.conv1d(x) + residual)


class _ConvActivation(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        self.conv1d = _conv(c["hidden_size"], c["intermediate_size"], c["intermediate_groups"])
        self.act = activation(c["hidden_act"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.conv1d(x))


class _SelfAttention(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        h = c["hidden_size"]
        self.heads = c["num_attention_heads"]
        self.query = _conv(h, h, c["q_groups"])
        self.key = _conv(h, h, c["k_groups"])
        self.value = _conv(h, h, c["v_groups"])

    def forward(self, x: torch.Tensor, blocked: torch.Tensor) -> torch.Tensor:
        N, C, W = x.shape
        d = C // self.heads
        q = self.query(x).view(N, self.heads, d, W).permute(0, 1, 3, 2)  # (N, heads, W, d)
        k = self.key(x).view(N, self.heads, d, W)  # (N, heads, d, W)
        v = self.value(x).view(N, self.heads, d, W).permute(0, 1, 3, 2)
        scores = torch.matmul(q, k) / math.sqrt(d)
        scores.masked_fill_(blocked, torch.finfo(scores.dtype).min)
        ctx = torch.matmul(torch.softmax(scores, dim=-1), v)  # (N, heads, W, d)
        return ctx.permute(0, 1, 3, 2).reshape(N, C, W)


class _Module(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        h, inter = c["hidden_size"], c["intermediate_size"]
        self.attention = _SelfAttention(c)
        self.post_attention = _ConvNorm(h, h, c["post_attention_groups"])
        self.intermediate = _ConvActivation(c)
        self.output = _ConvNorm(inter, h, c["output_groups"])

    def forward(self, x: torch.Tensor, blocked: torch.Tensor) -> torch.Tensor:
        a = self.post_attention(self.attention(x, blocked), x)
        return self.output(self.intermediate(a), a)


class _Embeddings(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        h = c["hidden_size"]
        self.word_embeddings = nn.Embedding(c["vocab_size"], h)
        self.position_embeddings = nn.Embedding(c["max_position_embeddings"], h)
        self.token_type_embeddings = nn.Embedding(c["type_vocab_size"], h)
        self.LayerNorm = nn.LayerNorm(h, eps=c["layer_norm_eps"])

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        x = self.word_embeddings(input_ids) + self.position_embeddings.weight[: input_ids.shape[1]]
        return self.LayerNorm(x + self.token_type_embeddings.weight[0])


class _Encoder(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        self.layers = nn.ModuleList(_Module(c) for _ in range(c["num_hidden_layers"]))


class SqueezeBertModel(nn.Module):
    """SqueezeBERT's encoder stack, widths from a transformers-style config
    dict (SqueezeBertConfig's names, defaults filled in)."""

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
        x = self.embeddings(input_ids).permute(0, 2, 1)  # NCW
        blocked = (attention_mask == 0)[:, None, None, :]  # (B, 1, 1, L): padded keys
        for layer in self.encoder.layers:
            x = layer(x, blocked)
        return x.permute(0, 2, 1)
