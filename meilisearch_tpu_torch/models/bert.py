"""BERT's encoder forward as a torch module (the port's K8), for the
BERT, RoBERTa, XLM-RoBERTa, CamemBERT, DistilBERT, MPNet and ELECTRA
checkpoints (`model_type` `bert`, `roberta`, `xlm-roberta`, `camembert`,
`distilbert`, `mpnet`, `electra`), which share one architecture (MPNet
adds a relative position bias, ELECTRA an embedding projection).

For BERT it computes what transformers' `FlaxBertModel` computes when the
JAX package's encoder (`models/hf_encoder.py` there) applies it under
`jax.jit`; for the RoBERTa family, what transformers' torch
`XLMRobertaModel` computes (the JAX package's branch for torch weights;
`CamembertModel` is the same model under another name);
for DistilBERT, what `FlaxDistilBertModel` and the torch
`DistilBertModel` compute (a DistilBERT config's `dim`, `n_layers`,
`n_heads` and `hidden_dim` are read as BERT's widths, and its weights
load under BERT's names, models/checkpoint.py); for MPNet, what the
torch `MPNetModel` computes (the JAX package's torch branch: transformers
has no Flax MPNet); for ELECTRA, what the torch `ElectraModel` computes
(the JAX package's torch branch; its Flax branch raises, fault 3.16). It
returns the last hidden state (the encoder reads no pooler):

- embeddings: word + token type (all zeros) + position, then LayerNorm
  (`layer_norm_eps`); dropout is off. BERT's positions are 0..L-1. The
  RoBERTa family's count from `pad_token_id` + 1 over the tokens that are
  not the pad id, and a pad token takes position `pad_token_id`
  (transformers' `create_position_ids_from_input_ids`). DistilBERT has no
  token-type embedding: word + position (0..L-1), LayerNorm eps 1e-12.
  MPNet has none either: word + position, its positions RoBERTa's from
  the padding id 1 (`MPNetEmbeddings` hard-codes it, whatever
  `pad_token_id` says; another pad id is refused). ELECTRA's embeddings
  and their LayerNorm are `embedding_size` wide (default `hidden_size`),
  positions 0..L-1; when that differs from `hidden_size`,
  `embeddings_project` (a Linear with bias) takes them to the encoder's
  width (google/electra-small-discriminator: 128 to 256);
- MPNet only: one relative position bias per forward, added in every
  layer. Bucket (i, j) of the raw indices' distance j - i follows
  `MPNetEncoder.relative_position_bucket` with its defaults (32 buckets,
  max distance 128, whatever the config's bucket count): 16 a sign, the
  first 8 distances exact, the rest logarithmic, a float32 `log`
  truncated to an integer. The (L, L) table is built on the host with
  the same torch float32 ops at the same shape, cached by L, and gathered
  from `encoder.relative_attention_bias` into a (1, heads, L, L) bias on
  the device;
- each layer: Q/K/V projections, scores (Q / sqrt(d_head)) K^T plus an
  additive bias of finfo(float32).min on padded keys (MPNet: (Q K^T) /
  sqrt(d_head), plus the position bias, then the padding bias: each
  family keeps its own order), softmax, times V,
  the output projection, residual and LayerNorm; then the intermediate
  projection, exact (erf) GELU, the output projection, residual and
  LayerNorm.

Attention is written as explicit products and a softmax, the same math
as `FlaxBertSelfAttention`, not `scaled_dot_product_attention`, which
picks its own kernels and rounding (and would move MPNet's bias). The
module's parameter names are those of transformers' torch `BertModel`
(`embeddings.word_embeddings.weight`,
`encoder.layer.{i}.attention.self.query.weight`, ...; MPNet's
`encoder.relative_attention_bias.weight`, ELECTRA's
`embeddings_project.weight`), so a checkpoint's tensors load by name
(models/checkpoint.py).

Everything runs in float32. On a CUDA device the forward raises when
`torch.backends.cuda.matmul.allow_tf32` is set (TF32 keeps about three
digits), as the vector float leg does (vector/store.py::_cos_column).
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Optional

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
ROBERTA_TYPES = ("roberta", "xlm-roberta", "camembert")
MODEL_TYPES = ("bert", *ROBERTA_TYPES, "distilbert", "mpnet", "electra")
# MPNet's fixed padding id, and the bucketing transformers always applies
# (MPNetEncoder.compute_position_bias passes num_buckets=32 and the
# default max_distance=128 whatever the config says)
MPNET_PAD_ID, MPNET_BUCKETS, MPNET_MAX_DISTANCE = 1, 32, 128
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
            "type_vocab_size": 0, "layer_norm_eps": 1e-12, "embedding_size": config["dim"]}


def _mpnet_config(config: dict) -> dict:
    pad = config.get("pad_token_id", MPNET_PAD_ID)
    if pad != MPNET_PAD_ID:
        raise ValueError(f"an mpnet config with pad_token_id {pad} is not supported:"
                         f" MPNetEmbeddings counts positions from {MPNET_PAD_ID}")
    buckets = config.get("relative_attention_num_buckets", MPNET_BUCKETS)
    if buckets < MPNET_BUCKETS:
        raise ValueError(f"relative_attention_num_buckets {buckets} is under the"
                         f" {MPNET_BUCKETS} buckets MPNet's position bias reads")
    return {**config, "type_vocab_size": 0, "pad_token_id": MPNET_PAD_ID,
            "relative_attention_num_buckets": buckets}


def check_config(config: dict) -> dict:
    """Raise ValueError unless `config` describes a model this module runs;
    return it with BERT's width names (CONFIG_KEYS; a DistilBERT config's
    widths renamed, `type_vocab_size` 0: no token-type embedding, as for
    MPNet; `embedding_size`, the embeddings' width, `hidden_size` unless an
    ELECTRA config gives another)."""
    model_type = config.get("model_type", "bert")
    if model_type not in MODEL_TYPES:
        raise ValueError(
            f"model_type `{model_type}` is not supported: the port runs BERT,"
            " RoBERTa, XLM-RoBERTa, CamemBERT, DistilBERT, MPNet and ELECTRA"
            " checkpoints here, ModernBERT ones in models/modernbert.py and"
            " DeBERTa-v2 ones in models/deberta_v2.py, no other"
        )
    if model_type == "distilbert":
        return _distilbert_config(config)
    if model_type == "mpnet":
        config = _mpnet_config(config)
    if model_type in ROBERTA_TYPES and config.get("pad_token_id") is None:
        raise ValueError(f"a `{model_type}` config must give pad_token_id")
    act = config.get("hidden_act", "gelu")
    if act != "gelu":
        raise ValueError(
            f"hidden_act `{act}` is not supported: the port runs exact GELU only"
        )
    positions = config.get("position_embedding_type", "absolute")
    if positions != "absolute":
        raise ValueError(f"position_embedding_type `{positions}` is not supported: the port"
                         " reads absolute position embeddings only")
    missing = [k for k in CONFIG_KEYS if k not in config]
    if missing:
        raise ValueError(f"the model config lacks {missing}")
    if config["hidden_size"] % config["num_attention_heads"]:
        raise ValueError("hidden_size is not a multiple of num_attention_heads")
    width = config.get("embedding_size") if model_type == "electra" else None
    return {**config, "embedding_size": width or config["hidden_size"]}


@lru_cache(maxsize=32)
def relative_position_buckets(n: int) -> torch.Tensor:
    """MPNet's (n, n) bucket table of the raw indices' distance, as
    `MPNetEncoder.compute_position_bias` and `relative_position_bucket`
    compute it: the same torch ops on the CPU, at the same shape, so that
    the float32 `log` rounds (and truncates) as there. int32, on the CPU."""
    pos = torch.arange(n, dtype=torch.long)
    relative = pos[None, :] - pos[:, None]  # memory - context
    num_buckets, max_distance = MPNET_BUCKETS, MPNET_MAX_DISTANCE
    ret = 0
    m = -relative
    num_buckets //= 2
    ret += (m < 0).to(torch.long) * num_buckets
    m = torch.abs(m)
    max_exact = num_buckets // 2
    is_small = m < max_exact
    val_if_large = max_exact + (
        torch.log(m.float() / max_exact) / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).to(torch.long)
    val_if_large = torch.min(val_if_large, torch.full_like(val_if_large, num_buckets - 1))
    ret += torch.where(is_small, m, val_if_large)
    return ret.to(torch.int32)


class _Embeddings(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        h = c["embedding_size"]
        self.word_embeddings = nn.Embedding(c["vocab_size"], h)
        self.position_embeddings = nn.Embedding(c["max_position_embeddings"], h)
        if c["type_vocab_size"]:
            self.token_type_embeddings = nn.Embedding(c["type_vocab_size"], h)
        else:  # DistilBERT
            self.token_type_embeddings = None
        self.LayerNorm = nn.LayerNorm(h, eps=c["layer_norm_eps"])
        from_pad = c.get("model_type", "bert") in (*ROBERTA_TYPES, "mpnet")
        self.padding_idx = c["pad_token_id"] if from_pad else None

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

    def forward(self, x: torch.Tensor, bias: torch.Tensor,
                position_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, L, h = x.shape
        d = h // self.heads

        def split(t):  # (B, L, h) -> (B, heads, L, d)
            return t.view(B, L, self.heads, d).transpose(1, 2)

        k, v = split(self.key(x)), split(self.value(x))
        if position_bias is None:  # Flax BERT's order: (Q / sqrt(d)) K^T
            scores = torch.matmul(split(self.query(x)) / math.sqrt(d), k.transpose(-1, -2))
        else:  # MPNet's: (Q K^T) / sqrt(d) + the position bias
            scores = torch.matmul(split(self.query(x)), k.transpose(-1, -2)) / math.sqrt(d)
            scores = scores + position_bias
        probs = torch.softmax(scores + bias, dim=-1)
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

    def forward(self, x: torch.Tensor, bias: torch.Tensor,
                position_bias: Optional[torch.Tensor]) -> torch.Tensor:
        return self.output(self.self(x, bias, position_bias), x)


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

    def forward(self, x: torch.Tensor, bias: torch.Tensor,
                position_bias: Optional[torch.Tensor]) -> torch.Tensor:
        a = self.attention(x, bias, position_bias)
        return self.output(self.intermediate(a), a)


class _Encoder(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        self.layer = nn.ModuleList(_Layer(c) for _ in range(c["num_hidden_layers"]))
        if c.get("model_type") == "mpnet":  # (buckets, heads)
            self.relative_attention_bias = nn.Embedding(
                c["relative_attention_num_buckets"], c["num_attention_heads"])
        else:
            self.relative_attention_bias = None

    def position_bias(self, L: int, device: torch.device) -> Optional[torch.Tensor]:
        """MPNet's (1, heads, L, L) bias; None for the other families."""
        if self.relative_attention_bias is None:
            return None
        buckets = relative_position_buckets(L).to(device)
        return self.relative_attention_bias(buckets).permute(2, 0, 1).unsqueeze(0)


class BertModel(nn.Module):
    """BERT's encoder stack, widths from a transformers-style config dict
    (the RoBERTa family's positions, DistilBERT's layout, MPNet's
    positions and relative position bias, or ELECTRA's embedding
    projection, when `model_type` names it); `config` holds BERT's width
    names."""

    def __init__(self, config: dict):
        super().__init__()
        config = check_config(config)
        self.config = config
        self.embeddings = _Embeddings(config)
        if config["embedding_size"] != config["hidden_size"]:  # ELECTRA-small
            self.embeddings_project = nn.Linear(config["embedding_size"], config["hidden_size"])
        else:
            self.embeddings_project = None
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
        if self.embeddings_project is not None:
            x = self.embeddings_project(x)
        # (B, 1, 1, L): 0 on real keys, float32's lowest on padded ones
        bias = torch.where(
            attention_mask[:, None, None, :] > 0,
            torch.zeros((), dtype=x.dtype, device=x.device),
            torch.full((), torch.finfo(x.dtype).min, dtype=x.dtype, device=x.device),
        )
        position_bias = self.encoder.position_bias(input_ids.shape[1], x.device)
        for layer in self.encoder.layer:
            x = layer(x, bias, position_bias)
        return x
