"""BERT's encoder forward as a torch module (the port's K8), for the
BERT, RoBERTa, XLM-RoBERTa, CamemBERT, data2vec-text, XLM-RoBERTa-XL,
DistilBERT, MPNet, ELECTRA, ERNIE, BertGeneration, RemBERT, Megatron-BERT
and BigBird checkpoints (`model_type` `bert`, `roberta`, `xlm-roberta`,
`camembert`, `data2vec-text`, `xlm-roberta-xl`, `distilbert`, `mpnet`,
`electra`, `ernie`, `bert-generation`, `rembert`, `megatron-bert`,
`big_bird`), which share one architecture (MPNet adds a relative position
bias, ELECTRA and RemBERT an embedding projection, ERNIE a task-type
embedding, Megatron-BERT and XLM-RoBERTa-XL move their LayerNorms before
each block, BigBird may scale its word embeddings).

For BERT it computes what transformers' `FlaxBertModel` computes when the
JAX package's encoder (`models/hf_encoder.py` there) applies it under
`jax.jit`; for the RoBERTa family, what transformers' torch
`XLMRobertaModel` computes (the JAX package's branch for torch weights;
`CamembertModel` and `Data2VecTextModel` are the same model under other
names);
for DistilBERT, what `FlaxDistilBertModel` and the torch
`DistilBertModel` compute (a DistilBERT config's `dim`, `n_layers`,
`n_heads` and `hidden_dim` are read as BERT's widths, and its weights
load under BERT's names, models/checkpoint.py); for MPNet, ELECTRA,
ERNIE, BertGeneration, RemBERT, Megatron-BERT, XLM-RoBERTa-XL and
BigBird, what the torch `MPNetModel`, `ElectraModel`, `ErnieModel`,
`BertGenerationEncoder`, `RemBertModel`, `MegatronBertModel`,
`XLMRobertaXLModel` and `BigBirdModel` compute (the JAX package's torch
branch: transformers has no Flax model of most of these, its Flax ELECTRA
raises, fault 3.16, and a BigBird reference is read from
pytorch_model.bin, fault 3.27). It returns the last hidden state (the
encoder reads no pooler):

- embeddings: word + token type (all zeros) + position, then LayerNorm
  (`layer_norm_eps`); dropout is off. BERT's positions are 0..L-1, and so
  are BigBird's. The
  RoBERTa family's count from `pad_token_id` + 1 over the tokens that are
  not the pad id, and a pad token takes position `pad_token_id`
  (transformers' `create_position_ids_from_input_ids`). DistilBERT has no
  token-type embedding: word + position (0..L-1), LayerNorm eps 1e-12;
  with `sinusoidal_pos_embds` the position table is the file's, as the
  torch `DistilBertModel` loads it (transformers writes the sinusoid into
  it and never trains it), and its `activation` is any of
  models/activations.py's;
  MPNet has none either: word + position, its positions RoBERTa's from
  the padding id 1 (`MPNetEmbeddings` hard-codes it, whatever
  `pad_token_id` says; another pad id is refused); nor has BertGeneration
  (word + position). ERNIE adds, after the positions, row 0 of
  `task_type_embeddings` when `use_task_id` (transformers' default
  task_type_ids are zeros). Megatron-BERT's and XLM-RoBERTa-XL's
  embeddings have no LayerNorm. BigBird with `rescale_embeddings`
  multiplies the word embeddings by sqrt(hidden_size) before the token
  type is added.
  ELECTRA's embeddings and their LayerNorm are `embedding_size` wide
  (default `hidden_size`), RemBERT's `input_embedding_size` wide; when
  that differs from `hidden_size`, `embeddings_project` (a Linear with
  bias; RemBERT's `encoder.embedding_hidden_mapping_in`, renamed by
  models/checkpoint.py) takes them to the encoder's width
  (google/electra-small-discriminator: 128 to 256; google/rembert: 256
  to 1152);
- `position_embedding_type` `relative_key` or `relative_key_query`
  (read, as transformers reads it, by `bert`, the RoBERTa family,
  `electra`, `ernie`, `megatron-bert` and `bert-generation`): no absolute
  position is added (but for BertGeneration, whose embeddings always add
  it), and each layer's `attention.self.distance_embedding`
  (2 max_position_embeddings - 1 rows of head_dim) is gathered at
  l - r + max_position_embeddings - 1 for query l and key r, the (L, L)
  index built on the host and cached by L; the scores are
  `BertSelfAttention`'s eager order: Q K^T, plus einsum(Q, pos) (and
  einsum(K, pos) for `relative_key_query`), then / sqrt(d_head);
- MPNet only: one relative position bias per forward, added in every
  layer. Bucket (i, j) of the raw indices' distance j - i follows
  `MPNetEncoder.relative_position_bucket` with its defaults (32 buckets,
  max distance 128, whatever the config's bucket count): 16 a sign, the
  first 8 distances exact, the rest logarithmic, a float32 `log`
  truncated to an integer. The (L, L) table is built on the host with
  the same torch float32 ops at the same shape, cached by L, and gathered
  from `encoder.relative_attention_bias` into a (1, heads, L, L) bias on
  the device;
- each layer: Q/K/V projections, scores (Q / sqrt(d_head)) K^T (MPNet:
  (Q K^T) / sqrt(d_head), plus the position bias; the relative keys'
  order above: each family keeps its own), padded keys' scores REPLACED
  by finfo(float32).min (`masked_fill_`, never added), softmax, times V,
  the output projection, residual and LayerNorm; then the intermediate
  projection, the activation (`hidden_act` through models/activations.py:
  exact (erf) GELU by default, BigBird's `gelu_new` by its default, and
  the rest of its list; another name is refused), the output projection,
  residual and LayerNorm. Megatron-BERT's and XLM-RoBERTa-XL's layers are
  pre-LayerNorm: `attention.ln` before self-attention and the residual
  added with no norm after, `ln` before the intermediate and again no
  norm after, and `encoder.ln` after the last layer (XLM-RoBERTa-XL's
  `attention.self_attn_layer_norm`, its layer's `LayerNorm` and
  `encoder.LayerNorm`, renamed by position in models/checkpoint.py).
- BigBird: `attention_type` `original_full` runs BERT's full attention.
  `block_sparse` runs it too wherever transformers falls back to it, on a
  batch of at most (5 + 2 num_random_blocks) block_size tokens
  (`BigBirdModel.forward`), and on a longer batch pads it to a multiple
  of block_size and runs models/big_bird.py's block-sparse attention in
  every layer, then cuts the padding off. The choice is made for each
  forward by the batch's padded length alone: the model keeps no
  attention type (transformers' switch to full attention persists, fault
  3.28). `use_bias` false is refused.

Attention is written as explicit products and a softmax, the same math
as `FlaxBertSelfAttention`, not `scaled_dot_product_attention`, which
picks its own kernels and rounding (and would move MPNet's bias). The
module's parameter names are those of transformers' torch `BertModel`
(`embeddings.word_embeddings.weight`,
`encoder.layer.{i}.attention.self.query.weight`, ...; MPNet's
`encoder.relative_attention_bias.weight`, ELECTRA's
`embeddings_project.weight`, ERNIE's
`embeddings.task_type_embeddings.weight`, the relative keys'
`encoder.layer.{i}.attention.self.distance_embedding.weight`,
Megatron-BERT's `encoder.layer.{i}.attention.ln.weight`,
`encoder.layer.{i}.ln.weight` and `encoder.ln.weight`), so a
checkpoint's tensors load by name (models/checkpoint.py).

Everything runs in float32. On a CUDA device the forward raises when
`torch.backends.cuda.matmul.allow_tf32` is set (TF32 keeps about three
digits), as the vector float leg does (vector/store.py::_cos_column).
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Optional

import torch
from torch import nn

from . import big_bird
from .activations import activation
from .big_bird import sparse_threshold

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
ROBERTA_TYPES = ("roberta", "xlm-roberta", "camembert", "data2vec-text", "xlm-roberta-xl")
BIG_BIRD = "big_bird"
MODEL_TYPES = ("bert", *ROBERTA_TYPES, "distilbert", "mpnet", "electra", "ernie",
               "bert-generation", "rembert", "megatron-bert", BIG_BIRD)
# model types whose layers norm before each block, not after, and whose
# embeddings have no LayerNorm
PRE_NORM_TYPES = ("megatron-bert", "xlm-roberta-xl")
# model types whose transformers modules read `relative_key` and
# `relative_key_query` (RemBERT's, DistilBERT's and MPNet's do not)
RELATIVE_TYPES = ("bert", *ROBERTA_TYPES, "electra", "ernie", "bert-generation",
                  "megatron-bert")
RELATIVE_KEYS = ("relative_key", "relative_key_query")
# MPNet's fixed padding id, and the bucketing transformers always applies
# (MPNetEncoder.compute_position_bias passes num_buckets=32 and the
# default max_distance=128 whatever the config says)
MPNET_PAD_ID, MPNET_BUCKETS, MPNET_MAX_DISTANCE = 1, 32, 128
# BigBirdConfig's defaults for its own keys
BIG_BIRD_DEFAULTS = {"hidden_act": "gelu_new", "attention_type": "block_sparse", "use_bias": True,
                     "rescale_embeddings": False, "block_size": 64, "num_random_blocks": 3,
                     "pad_token_id": 0}
# a DistilBERT config's widths (transformers' DistilBertConfig names)
DISTILBERT_KEYS = ("vocab_size", "dim", "n_layers", "n_heads", "hidden_dim", "activation",
                   "max_position_embeddings")


def _distilbert_config(config: dict) -> dict:
    missing = [k for k in DISTILBERT_KEYS if k not in config]
    if missing:
        raise ValueError(f"the distilbert config lacks {missing}")
    activation(config["activation"], "activation")
    if config["dim"] % config["n_heads"]:
        raise ValueError("dim is not a multiple of n_heads")
    return {**config, "hidden_size": config["dim"], "num_hidden_layers": config["n_layers"],
            "num_attention_heads": config["n_heads"], "intermediate_size": config["hidden_dim"],
            "type_vocab_size": 0, "layer_norm_eps": 1e-12, "embedding_size": config["dim"],
            "hidden_act": config["activation"], "position_embedding_type": "absolute"}


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


def _big_bird_config(config: dict) -> dict:
    config = {**BIG_BIRD_DEFAULTS, **config}
    kind = config["attention_type"]
    if kind not in ("original_full", "block_sparse"):
        raise ValueError(f"a big_bird attention_type `{kind}` is not supported: transformers"
                         " reads original_full and block_sparse")
    if not config["use_bias"]:
        raise ValueError("a big_bird config with use_bias false is not supported: the port's"
                         " attention projections have biases")
    return config


def check_config(config: dict) -> dict:
    """Raise ValueError unless `config` describes a model this module runs;
    return it with BERT's width names (CONFIG_KEYS; a DistilBERT config's
    widths renamed, `type_vocab_size` 0: no token-type embedding, as for
    MPNet and BertGeneration; `embedding_size`, the embeddings' width,
    `hidden_size` unless an ELECTRA config gives another or a RemBERT
    config its `input_embedding_size`; `hidden_act` and
    `position_embedding_type` with their defaults; a BigBird config's
    own keys with BigBirdConfig's)."""
    model_type = config.get("model_type", "bert")
    if model_type not in MODEL_TYPES:
        raise ValueError(
            f"model_type `{model_type}` is not supported: the port runs BERT, RoBERTa,"
            " XLM-RoBERTa, CamemBERT, data2vec-text, XLM-RoBERTa-XL, DistilBERT, MPNet,"
            " ELECTRA, ERNIE, BertGeneration, RemBERT, Megatron-BERT and BigBird"
            " checkpoints here, Longformer ones in models/longformer.py,"
            " ALBERT ones in models/albert.py,"
            " RoFormer ones in models/roformer.py, ModernBERT ones in models/modernbert.py,"
            " DeBERTa-v2 ones in models/deberta_v2.py, MobileBERT ones in"
            " models/mobilebert.py, SqueezeBERT ones in models/squeezebert.py, XLM ones in"
            " models/xlm.py (FlauBERT ones too) and XLNet ones in models/xlnet.py, no other"
        )
    if model_type == "distilbert":
        return _distilbert_config(config)
    if model_type == "mpnet":
        config = _mpnet_config(config)
    elif model_type == "bert-generation":
        config = {**config, "type_vocab_size": 0}
    elif model_type == BIG_BIRD:
        config = _big_bird_config(config)
    if model_type in ROBERTA_TYPES and config.get("pad_token_id") is None:
        raise ValueError(f"a `{model_type}` config must give pad_token_id")
    act = config.get("hidden_act", "gelu")
    activation(act)
    positions = config.get("position_embedding_type", "absolute")
    if positions != "absolute" and (positions not in RELATIVE_KEYS
                                    or model_type not in RELATIVE_TYPES):
        raise ValueError(f"position_embedding_type `{positions}` is not supported for"
                         f" `{model_type}`: the port reads absolute position embeddings, and"
                         f" {' and '.join(RELATIVE_KEYS)} where transformers reads them"
                         f" ({', '.join(RELATIVE_TYPES)})")
    missing = [k for k in CONFIG_KEYS if k not in config]
    if model_type == "rembert" and "input_embedding_size" not in config:
        missing.append("input_embedding_size")
    if model_type == "ernie" and config.get("use_task_id") and "task_type_vocab_size" not in config:
        missing.append("task_type_vocab_size")
    if missing:
        raise ValueError(f"the model config lacks {missing}")
    if config["hidden_size"] % config["num_attention_heads"]:
        raise ValueError("hidden_size is not a multiple of num_attention_heads")
    width = {"electra": config.get("embedding_size"),
             "rembert": config.get("input_embedding_size")}.get(model_type)
    return {**config, "embedding_size": width or config["hidden_size"], "hidden_act": act,
            "position_embedding_type": positions}


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


@lru_cache(maxsize=32)
def distance_index(n: int, max_positions: int) -> torch.Tensor:
    """The relative keys' (n, n) row index into `distance_embedding`:
    query l minus key r, plus max_positions - 1. int64, on the CPU."""
    pos = torch.arange(n, dtype=torch.long)
    return pos[:, None] - pos[None, :] + (max_positions - 1)


def relative_scores(scores: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
                    pos: torch.Tensor, kind: str) -> torch.Tensor:
    """`scores` (B, heads, L, L) plus the relative keys' terms of (B, heads,
    L, d) q and k over the (L, L, d) distance embeddings `pos`, as
    transformers adds them: einsum(q, pos), then einsum(k, pos) for
    `relative_key_query`."""
    scores = scores + torch.einsum("bhld,lrd->bhlr", q, pos)
    if kind == "relative_key_query":
        scores = scores + torch.einsum("bhrd,lrd->bhlr", k, pos)
    return scores


class _Embeddings(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        h = c["embedding_size"]
        model_type = c.get("model_type", "bert")
        self.word_embeddings = nn.Embedding(c["vocab_size"], h)
        self.position_embeddings = nn.Embedding(c["max_position_embeddings"], h)
        if c["type_vocab_size"]:
            self.token_type_embeddings = nn.Embedding(c["type_vocab_size"], h)
        else:  # DistilBERT, MPNet, BertGeneration
            self.token_type_embeddings = None
        if model_type == "ernie" and c.get("use_task_id"):
            self.task_type_embeddings = nn.Embedding(c["task_type_vocab_size"], h)
        else:
            self.task_type_embeddings = None
        if model_type in PRE_NORM_TYPES:
            self.LayerNorm = None
        else:
            self.LayerNorm = nn.LayerNorm(h, eps=c["layer_norm_eps"])
        # models/longformer.py's embeddings are RoBERTa's
        from_pad = model_type in (*ROBERTA_TYPES, "mpnet", "longformer")
        self.padding_idx = c["pad_token_id"] if from_pad else None
        # BigBird's `rescale_embeddings`: the word embeddings times sqrt(hidden_size)
        self.scale = (c["hidden_size"] ** 0.5 if model_type == BIG_BIRD
                      and c["rescale_embeddings"] else None)
        # transformers adds absolute positions unless the keys are relative;
        # BertGenerationEmbeddings adds them whatever the config says
        self.absolute = (c.get("position_embedding_type", "absolute") == "absolute"
                         or model_type == "bert-generation")

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        L = input_ids.shape[1]
        # Flax's order: (words + token types) + positions (+ ERNIE's task type)
        x = self.word_embeddings(input_ids)
        if self.scale is not None:
            x = x * self.scale
        if self.token_type_embeddings is not None:
            x = x + self.token_type_embeddings.weight[0]
        if self.absolute and self.padding_idx is None:
            x = x + self.position_embeddings.weight[:L]
        elif self.absolute:
            real = (input_ids != self.padding_idx).long()
            positions = torch.cumsum(real, dim=1) * real + self.padding_idx
            x = x + self.position_embeddings(positions)
        if self.task_type_embeddings is not None:
            x = x + self.task_type_embeddings.weight[0]
        return x if self.LayerNorm is None else self.LayerNorm(x)


class _SelfAttention(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        h = c["hidden_size"]
        self.heads = c["num_attention_heads"]
        self.query = nn.Linear(h, h)
        self.key = nn.Linear(h, h)
        self.value = nn.Linear(h, h)
        self.relative = c.get("position_embedding_type", "absolute")
        if self.relative in RELATIVE_KEYS:
            self.distance_embedding = nn.Embedding(2 * c["max_position_embeddings"] - 1,
                                                   h // self.heads)
        else:
            self.distance_embedding = None

    def forward(self, x: torch.Tensor, blocked: torch.Tensor,
                position_bias: Optional[torch.Tensor] = None,
                distance: Optional[torch.Tensor] = None,
                sparse: Optional[big_bird.Layout] = None) -> torch.Tensor:
        B, L, h = x.shape
        d = h // self.heads

        def split(t):  # (B, L, h) -> (B, heads, L, d)
            return t.view(B, L, self.heads, d).transpose(1, 2)

        k, v = split(self.key(x)), split(self.value(x))
        if sparse is not None:  # BigBird's block-sparse attention
            out = big_bird.attention(split(self.query(x)), k, v, sparse)
            return out.transpose(1, 2).reshape(B, L, h)
        if self.distance_embedding is not None:  # BertSelfAttention's order
            q = split(self.query(x))
            scores = torch.matmul(q, k.transpose(-1, -2))
            scores = relative_scores(scores, q, k, self.distance_embedding(distance),
                                     self.relative) / math.sqrt(d)
        elif position_bias is None:  # Flax BERT's order: (Q / sqrt(d)) K^T
            scores = torch.matmul(split(self.query(x)) / math.sqrt(d), k.transpose(-1, -2))
        else:  # MPNet's: (Q K^T) / sqrt(d) + the position bias
            scores = torch.matmul(split(self.query(x)), k.transpose(-1, -2)) / math.sqrt(d)
            scores = scores + position_bias
        scores.masked_fill_(blocked, torch.finfo(scores.dtype).min)
        probs = torch.softmax(scores, dim=-1)
        return torch.matmul(probs, v).transpose(1, 2).reshape(B, L, h)


class _Output(nn.Module):
    """dense, then LayerNorm(dense(x) + residual); Megatron-BERT's has no
    LayerNorm (`norm` false): dense(x) + residual."""

    def __init__(self, n_in: int, c: dict, norm: bool = True):
        super().__init__()
        self.dense = nn.Linear(n_in, c["hidden_size"])
        if norm:
            self.LayerNorm = nn.LayerNorm(c["hidden_size"], eps=c["layer_norm_eps"])
        else:
            self.LayerNorm = None

    def forward(self, x: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
        y = self.dense(x) + residual
        return y if self.LayerNorm is None else self.LayerNorm(y)


def _pre_norm(c: dict) -> bool:
    """Megatron-BERT's and XLM-RoBERTa-XL's layers norm before each block,
    not after."""
    return c.get("model_type") in PRE_NORM_TYPES


class _Attention(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        if _pre_norm(c):
            self.ln = nn.LayerNorm(c["hidden_size"], eps=c["layer_norm_eps"])
        else:
            self.ln = None
        self.self = _SelfAttention(c)
        self.output = _Output(c["hidden_size"], c, norm=self.ln is None)

    def forward(self, x: torch.Tensor, blocked: torch.Tensor,
                position_bias: Optional[torch.Tensor],
                distance: Optional[torch.Tensor],
                sparse: Optional[big_bird.Layout] = None) -> torch.Tensor:
        h = x if self.ln is None else self.ln(x)
        return self.output(self.self(h, blocked, position_bias, distance, sparse), x)


class _Intermediate(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        self.dense = nn.Linear(c["hidden_size"], c["intermediate_size"])
        self.act = activation(c.get("hidden_act", "gelu"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.dense(x))


class _Layer(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        self.attention = _Attention(c)
        if _pre_norm(c):
            self.ln = nn.LayerNorm(c["hidden_size"], eps=c["layer_norm_eps"])
        else:
            self.ln = None
        self.intermediate = _Intermediate(c)
        self.output = _Output(c["intermediate_size"], c, norm=self.ln is None)

    def forward(self, x: torch.Tensor, blocked: torch.Tensor,
                position_bias: Optional[torch.Tensor],
                distance: Optional[torch.Tensor],
                sparse: Optional[big_bird.Layout] = None) -> torch.Tensor:
        a = self.attention(x, blocked, position_bias, distance, sparse)
        h = a if self.ln is None else self.ln(a)
        return self.output(self.intermediate(h), a)


class _Encoder(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        self.layer = nn.ModuleList(_Layer(c) for _ in range(c["num_hidden_layers"]))
        if c.get("model_type") == "mpnet":  # (buckets, heads)
            self.relative_attention_bias = nn.Embedding(
                c["relative_attention_num_buckets"], c["num_attention_heads"])
        else:
            self.relative_attention_bias = None
        if _pre_norm(c):  # Megatron-BERT's and XLM-RoBERTa-XL's final LayerNorm
            self.ln = nn.LayerNorm(c["hidden_size"], eps=c["layer_norm_eps"])
        else:
            self.ln = None

    def position_bias(self, L: int, device: torch.device) -> Optional[torch.Tensor]:
        """MPNet's (1, heads, L, L) bias; None for the other families."""
        if self.relative_attention_bias is None:
            return None
        buckets = relative_position_buckets(L).to(device)
        return self.relative_attention_bias(buckets).permute(2, 0, 1).unsqueeze(0)


class BertModel(nn.Module):
    """BERT's encoder stack, widths from a transformers-style config dict
    (the RoBERTa family's positions, DistilBERT's layout, MPNet's
    positions and relative position bias, ELECTRA's or RemBERT's
    embedding projection, ERNIE's task type, BertGeneration's missing
    token type, Megatron-BERT's and XLM-RoBERTa-XL's pre-LayerNorm layers,
    BigBird's scaled word embeddings, or the relative keys, when the config
    names them); `config` holds BERT's width names."""

    def __init__(self, config: dict):
        super().__init__()
        config = check_config(config)
        self.config = config
        self.embeddings = _Embeddings(config)
        if config["embedding_size"] != config["hidden_size"]:  # ELECTRA-small, RemBERT
            self.embeddings_project = nn.Linear(config["embedding_size"], config["hidden_size"])
        else:
            self.embeddings_project = None
        self.encoder = _Encoder(config)
        # a block-sparse BigBird's threshold: a longer batch runs sparse
        self.sparse_threshold = (sparse_threshold(config) if config.get("model_type") == BIG_BIRD
                                 and config["attention_type"] == "block_sparse" else None)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        """(B, L) int64 ids and 0/1 mask -> (B, L, hidden) float32, the
        last hidden state."""
        if input_ids.is_cuda and torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError(
                "the text encoder needs full float32 matmuls:"
                " torch.backends.cuda.matmul.allow_tf32 is True"
            )
        L = input_ids.shape[1]
        sparse = None
        if self.sparse_threshold is not None and L > self.sparse_threshold:
            c = self.config
            input_ids, attention_mask = big_bird.pad_to_block(
                input_ids, attention_mask, c["block_size"], c["pad_token_id"],
                c["max_position_embeddings"])
            sparse = big_bird.layout(attention_mask, c["block_size"], c["num_random_blocks"])
            big_bird.FORWARDS.add()
        x = self.embeddings(input_ids)
        if self.embeddings_project is not None:
            x = self.embeddings_project(x)
        blocked = (attention_mask == 0)[:, None, None, :]  # (B, 1, 1, L): padded keys
        position_bias = self.encoder.position_bias(L, x.device)
        distance = None
        if self.config["position_embedding_type"] in RELATIVE_KEYS:
            distance = distance_index(L, self.config["max_position_embeddings"]).to(x.device)
        for layer in self.encoder.layer:
            x = layer(x, blocked, position_bias, distance, sparse)
        x = x if self.encoder.ln is None else self.encoder.ln(x)
        return x[:, :L]
