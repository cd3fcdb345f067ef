"""DeBERTa-v2's encoder forward as a torch module (the port's K8 for
`model_type` `deberta-v2`: microsoft/deberta-v3-base, deberta-v2-xlarge
and -xxlarge, and the models fine-tuned from them).

It computes what transformers' torch `DebertaV2Model` computes, the model
the JAX package's encoder (`models/hf_encoder.py` there) runs through its
torch branch, since transformers has no Flax DeBERTa-v2. It returns the
last hidden state (pooling stays in models/hf_encoder.py):

- embeddings: word embeddings (`embedding_size` wide, default
  `hidden_size`), plus position embeddings (0..L-1) only with
  `position_biased_input`, plus the token-type embedding of type 0 only
  when `type_vocab_size` > 0; `embed_proj` (no bias) to `hidden_size`
  when the widths differ; LayerNorm (`layer_norm_eps`, 1e-7 in v3); then
  times the attention mask, so padded rows are zeros;
- relative positions (`relative_attention`): the (L, L) table of query
  index minus key index, bucketed when `position_buckets` > 0 and the
  maximum distance (`max_relative_positions`, or `max_position_embeddings`
  when under 1) is too: distances under mid = `position_buckets` / 2 are
  exact, farther ones `ceil(log(|r| / mid) / log((max - 1) / mid) *
  (mid - 1)) + mid` with their sign, in float32 (transformers'
  `make_log_bucket_position`). The table, and from it the c2p and p2c
  gather indexes `clamp(±r + span, 0, 2 * span - 1)`, are built on the
  host with transformers' own torch ops at shape (L, L), cached by L, and
  copied to the device: a float32 `log` on another device may round a
  bucket edge otherwise;
- `encoder.rel_embeddings.weight[:2 * span]` (span = `position_buckets`,
  else the maximum distance), through `encoder.LayerNorm` when
  `norm_rel_ebd` holds `layer_norm`;
- each layer's disentangled attention: Q, K, V projections; `scale =
  sqrt(float32(d_head) * scale_factor)`, a float32 tensor op (scale_factor
  is 1 plus one for each of `c2p` and `p2c` in `pos_att_type`, a list or
  the published string "p2c|c2p"); scores `Q @ (K^T / scale)`; c2p: `Q @
  pos_key^T` gathered at the c2p index, over scale; p2c: `K @ pos_query^T`
  gathered at the p2c index and transposed, over scale; the scores plus
  (c2p + p2c), in transformers' order. With `share_att_key`, pos_key and
  pos_query are `key_proj` and `query_proj` of the relative embeddings,
  else `pos_key_proj` and `pos_query_proj`;
- the mask (B, 1, L, L), query and key both real, REPLACES the scores
  (`masked_fill` with finfo(float32).min), never adds to them; softmax,
  times V; a padded query row is uniform, and mean pooling drops it;
- then the output projection, residual and LayerNorm; the intermediate
  projection, exact (erf) GELU, the output projection, residual and
  LayerNorm, as in BERT.

- with `conv_kernel_size` > 0 (deberta-v2-xlarge and -xxlarge), layer 0's
  output goes through the `ConvLayer` (`encoder.conv`): a `Conv1d` over
  the EMBEDDING output (`conv_kernel_size` wide, padding (k - 1) // 2,
  `conv_groups`; models/conv.py's grouped product, not cuDNN's TF32), its
  padded positions zeroed, `conv_act` (models/activations.py; default
  `tanh`, `gelu` in the published files), then LayerNorm(layer 0's output
  + that), times the mask; the next layers read that;
- with `relative_attention: false` no relative term is added; without
  `position_biased_input` too the model reads no position at all, as
  transformers runs it. The scale's factor counts `pos_att_type` either
  way, as `DisentangledSelfAttention` counts it.

Refused by name: another `hidden_act`, an `attention_head_size` that is
not hidden_size / heads, a `conv_act` outside models/activations.py,
`conv_groups` that do not divide the hidden size and an even
`conv_kernel_size` (transformers raises on it).

Attention is written as explicit products and a softmax, not
`scaled_dot_product_attention`. Parameter names are `DebertaV2Model`'s
(`embeddings.word_embeddings.weight`, `embeddings.LayerNorm.weight`,
`encoder.layer.{i}.attention.self.query_proj.weight`, `key_proj`,
`value_proj`, `pos_key_proj`, `pos_query_proj`,
`encoder.layer.{i}.attention.output.dense.weight`, ...,
`encoder.rel_embeddings.weight`, `encoder.LayerNorm.weight`), so a
checkpoint's tensors load by name (models/checkpoint.py).

Everything runs in float32. On a CUDA device the forward raises when
`torch.backends.cuda.matmul.allow_tf32` is set, as models/bert.py does.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .activations import activation
from .conv import Conv1d

# the widths a config must give (transformers' DebertaV2Config names)
CONFIG_KEYS = (
    "vocab_size",
    "hidden_size",
    "num_hidden_layers",
    "num_attention_heads",
    "intermediate_size",
    "max_position_embeddings",
)
# DebertaV2Config's defaults for what a config.json may leave out
DEFAULTS = {"hidden_act": "gelu", "type_vocab_size": 0, "layer_norm_eps": 1e-7,
            "relative_attention": False, "max_relative_positions": -1, "pad_token_id": 0,
            "position_biased_input": True, "pos_att_type": None, "position_buckets": -1,
            "share_att_key": False, "norm_rel_ebd": "none", "conv_kernel_size": 0,
            "conv_groups": 1, "conv_act": "tanh"}


def check_config(config: dict) -> dict:
    """Raise ValueError unless `config` describes a DeBERTa-v2 this module
    runs; return it with DebertaV2Config's defaults filled in, `pos_att_type`
    as a list, `embedding_size` and `max_relative_positions` resolved."""
    if config.get("model_type") != "deberta-v2":
        raise ValueError(f"model_type `{config.get('model_type')}` is not deberta-v2")
    config = {**DEFAULTS, **config}
    missing = [k for k in CONFIG_KEYS if k not in config]
    if missing:
        raise ValueError(f"the deberta-v2 config lacks {missing}")
    if config["hidden_act"] != "gelu":
        raise ValueError(f"hidden_act `{config['hidden_act']}` is not supported: the port runs"
                         " exact GELU only")
    if config["conv_kernel_size"] > 0:
        activation(config["conv_act"], "conv_act")
        if config["conv_kernel_size"] % 2 == 0:
            raise ValueError(f"an even conv_kernel_size ({config['conv_kernel_size']}) is not"
                             " supported: its padding shortens the sequence, and transformers'"
                             " ConvLayer raises on the residual")
        if config["hidden_size"] % config["conv_groups"]:
            raise ValueError(f"conv_groups {config['conv_groups']} does not divide hidden_size:"
                             " torch's Conv1d raises on it")
    if config["hidden_size"] % config["num_attention_heads"]:
        raise ValueError("hidden_size is not a multiple of num_attention_heads")
    head = config["hidden_size"] // config["num_attention_heads"]
    if config.get("attention_head_size") not in (None, head):
        raise ValueError(f"attention_head_size {config['attention_head_size']} is not"
                         f" supported: the port's heads are hidden_size / num_attention_heads"
                         f" = {head} wide")
    kinds = config["pos_att_type"] or []
    if isinstance(kinds, str):  # the published spelling, "p2c|c2p"
        kinds = [x.strip() for x in kinds.lower().split("|")]
    unknown = [k for k in kinds if k not in ("c2p", "p2c")]
    if unknown:
        raise ValueError(f"pos_att_type {unknown} is not supported: the port reads c2p and p2c")
    max_rel = config["max_relative_positions"]
    if max_rel < 1:
        max_rel = config["max_position_embeddings"]
    norms = config["norm_rel_ebd"] or "none"
    if isinstance(norms, str):  # "layer_norm", or names joined by "|"
        norms = [x.strip() for x in norms.lower().split("|")]
    return {**config, "pos_att_type": kinds, "max_relative_positions": max_rel,
            "embedding_size": config.get("embedding_size") or config["hidden_size"],
            "norm_rel_ebd": norms}


def attention_span(config: dict) -> int:
    """The relative distances an attention reads on each side:
    `position_buckets` when set, else the maximum distance."""
    buckets = config["position_buckets"]
    return buckets if buckets > 0 else config["max_relative_positions"]


def scale_factor(config: dict) -> int:
    return 1 + len(set(config["pos_att_type"]) & {"c2p", "p2c"})


def attention_scale(config: dict, device: torch.device) -> torch.Tensor:
    """sqrt(d_head * scale_factor) as transformers' `scaled_size_sqrt`
    computes it, a float32 tensor op (math.sqrt rounds some sizes, such as
    89 * 3, to another float32), as a 0-d tensor on `device`: CUDA
    multiplies by the reciprocal of a CPU scalar divisor, the CPU
    divides."""
    d = config["hidden_size"] // config["num_attention_heads"]
    return torch.sqrt(torch.tensor(d, dtype=torch.float) * scale_factor(config)).to(device)


@lru_cache(maxsize=32)
def relative_positions(n: int, bucket_size: int, max_position: int) -> torch.Tensor:
    """The (n, n) int64 table of query index minus key index, bucketed as
    transformers' `build_relative_position` and `make_log_bucket_position`
    bucket it: the same torch ops on the CPU, at the same shape, so the
    float32 `log` rounds (and `ceil` rounds up) as there. On the CPU."""
    ids = torch.arange(n, dtype=torch.long)
    rel = ids[:, None] - ids[None, :]
    if bucket_size > 0 and max_position > 0:
        sign = torch.sign(rel)
        mid = bucket_size // 2
        abs_pos = torch.where((rel < mid) & (rel > -mid), torch.tensor(mid - 1).type_as(rel),
                              torch.abs(rel))
        log_pos = torch.ceil(torch.log(abs_pos / mid)
                             / torch.log(torch.tensor((max_position - 1) / mid))
                             * (mid - 1)) + mid
        rel = torch.where(abs_pos <= mid, rel.type_as(log_pos), log_pos * sign)
    return rel.to(torch.long)


@lru_cache(maxsize=64)
def gather_indexes(n: int, bucket_size: int, max_position: int, span: int,
                   device: torch.device) -> tuple:
    """(c2p, p2c), each (n, n) int64 on `device`: the columns of the
    (L, 2 * span) position products that c2p and p2c gather, built on the
    CPU from `relative_positions` and then copied."""
    rel = relative_positions(n, bucket_size, max_position)
    c2p = torch.clamp(rel + span, 0, span * 2 - 1)
    p2c = torch.clamp(-rel + span, 0, span * 2 - 1)
    return c2p.to(device), p2c.to(device)


class _Embeddings(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        e, h = c["embedding_size"], c["hidden_size"]
        self.word_embeddings = nn.Embedding(c["vocab_size"], e)
        self.position_embeddings = (nn.Embedding(c["max_position_embeddings"], e)
                                    if c["position_biased_input"] else None)
        self.token_type_embeddings = (nn.Embedding(c["type_vocab_size"], e)
                                      if c["type_vocab_size"] > 0 else None)
        self.embed_proj = nn.Linear(e, h, bias=False) if e != h else None
        self.LayerNorm = nn.LayerNorm(h, eps=c["layer_norm_eps"])

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        x = self.word_embeddings(input_ids)
        if self.position_embeddings is not None:
            x = x + self.position_embeddings.weight[: input_ids.shape[1]]
        if self.token_type_embeddings is not None:
            x = x + self.token_type_embeddings.weight[0]
        if self.embed_proj is not None:
            x = self.embed_proj(x)
        return self.LayerNorm(x) * attention_mask[:, :, None].to(x.dtype)


class _SelfAttention(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        h = c["hidden_size"]
        self.heads = c["num_attention_heads"]
        self.kinds = c["pos_att_type"]
        self.relative = c["relative_attention"]
        self.query_proj = nn.Linear(h, h)
        self.key_proj = nn.Linear(h, h)
        self.value_proj = nn.Linear(h, h)
        self.share_att_key = c["share_att_key"]
        if self.relative and not self.share_att_key:
            if "c2p" in self.kinds:
                self.pos_key_proj = nn.Linear(h, h)
            if "p2c" in self.kinds:
                self.pos_query_proj = nn.Linear(h, h)

    def _split(self, t: torch.Tensor) -> torch.Tensor:
        """(..., n, h) -> (..., heads, n, d)."""
        *lead, n, h = t.shape
        return t.view(*lead, n, self.heads, h // self.heads).transpose(-3, -2)

    def forward(self, x: torch.Tensor, mask: torch.Tensor, scale: torch.Tensor,
                rel: Optional[tuple]) -> torch.Tensor:
        B, L, h = x.shape
        q, k, v = (self._split(p(x)) for p in (self.query_proj, self.key_proj, self.value_proj))
        scores = torch.matmul(q, k.transpose(-1, -2) / scale)
        if self.relative:
            rel_embeddings, (c2p_index, p2c_index) = rel
            shape = (B, self.heads, L, L)
            score = None
            if "c2p" in self.kinds:  # content -> position
                proj = self.key_proj if self.share_att_key else self.pos_key_proj
                pos_key = self._split(proj(rel_embeddings))  # (heads, 2 span, d)
                score = torch.gather(torch.matmul(q, pos_key.transpose(-1, -2)), -1,
                                     c2p_index.expand(shape)) / scale
            if "p2c" in self.kinds:  # position -> content
                proj = self.query_proj if self.share_att_key else self.pos_query_proj
                pos_query = self._split(proj(rel_embeddings))
                p2c = torch.gather(torch.matmul(k, pos_query.transpose(-1, -2)), -1,
                                   p2c_index.expand(shape)).transpose(-1, -2) / scale
                score = p2c if score is None else score + p2c
            if score is not None:
                scores = scores + score
        scores = scores.masked_fill(~mask, torch.finfo(scores.dtype).min)
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

    def forward(self, x, mask, scale, rel) -> torch.Tensor:
        return self.output(self.self(x, mask, scale, rel), x)


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

    def forward(self, x, mask, scale, rel) -> torch.Tensor:
        a = self.attention(x, mask, scale, rel)
        return self.output(self.intermediate(a), a)


class _ConvLayer(nn.Module):
    """DeBERTa-v2's ConvLayer after layer 0: a Conv1d over the embedding
    output, padded positions zeroed, `conv_act`, LayerNorm(layer 0's
    output + that), times the mask."""

    def __init__(self, c: dict):
        super().__init__()
        k, h = c["conv_kernel_size"], c["hidden_size"]
        self.conv = Conv1d(h, h, k, padding=(k - 1) // 2, groups=c["conv_groups"])
        self.LayerNorm = nn.LayerNorm(h, eps=c["layer_norm_eps"])
        self.act = activation(c["conv_act"], "conv_act")

    def forward(self, embedded: torch.Tensor, residual: torch.Tensor,
                attention_mask: torch.Tensor) -> torch.Tensor:
        out = self.conv(embedded.permute(0, 2, 1)).permute(0, 2, 1)
        out = out.masked_fill((attention_mask == 0)[:, :, None], 0)
        keep = attention_mask[:, :, None].to(out.dtype)
        return self.LayerNorm(residual + self.act(out)) * keep


class _Encoder(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        self.layer = nn.ModuleList(_Layer(c) for _ in range(c["num_hidden_layers"]))
        if c["relative_attention"]:
            self.rel_embeddings = nn.Embedding(2 * attention_span(c), c["hidden_size"])
        if "layer_norm" in c["norm_rel_ebd"]:
            self.LayerNorm = nn.LayerNorm(c["hidden_size"], eps=c["layer_norm_eps"])
        self.conv = _ConvLayer(c) if c["conv_kernel_size"] > 0 else None


class DebertaV2Model(nn.Module):
    """DeBERTa-v2's encoder stack, widths from a transformers-style config
    dict (`config` holds DebertaV2Config's names, defaults filled in)."""

    def __init__(self, config: dict):
        super().__init__()
        config = check_config(config)
        self.config = config
        self.embeddings = _Embeddings(config)
        self.encoder = _Encoder(config)

    def relative(self, L: int, device: torch.device) -> Optional[tuple]:
        """(relative embeddings (2 span, hidden), (c2p index, p2c index)) for
        a forward at length L; None without relative attention."""
        c = self.config
        if not c["relative_attention"]:
            return None
        span = attention_span(c)
        emb = self.encoder.rel_embeddings.weight[: 2 * span]
        if "layer_norm" in c["norm_rel_ebd"]:
            emb = self.encoder.LayerNorm(emb)
        return emb, gather_indexes(L, c["position_buckets"], c["max_relative_positions"], span,
                                   device)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        """(B, L) int64 ids and 0/1 mask -> (B, L, hidden) float32, the
        last hidden state."""
        if input_ids.is_cuda and torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError(
                "the text encoder needs full float32 matmuls:"
                " torch.backends.cuda.matmul.allow_tf32 is True"
            )
        c = self.config
        x = self.embeddings(input_ids, attention_mask)
        real = attention_mask > 0
        mask = real[:, None, None, :] & real[:, None, :, None]  # (B, 1, L, L)
        scale = attention_scale(c, x.device)
        rel = self.relative(input_ids.shape[1], x.device)
        embedded = x
        for i, layer in enumerate(self.encoder.layer):
            x = layer(x, mask, scale, rel)
            if i == 0 and self.encoder.conv is not None:
                x = self.encoder.conv(embedded, x, attention_mask)
        return x
