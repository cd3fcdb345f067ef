"""The decoder embedders' forward as one torch module (the port's K8 for
`model_type` `qwen3`, `qwen2`, `llama` and `mistral`: Qwen3-Embedding,
gte-Qwen2, Llama and e5-mistral).

It computes what transformers' torch `Qwen3Model`, `Qwen2Model`,
`LlamaModel` and `MistralModel` compute under their default attention
(`sdpa`) on a padded batch with no cache, the models the JAX package's
encoder (`models/hf_encoder.py` there) runs through its torch branch. It
returns the last hidden state (pooling stays in models/hf_encoder.py):

- `embed_tokens`; no position embedding;
- each layer, pre-norm: `input_layernorm`, an RMSNorm (the mean square in
  float32, `x * rsqrt(ms + eps)`, then the weight times that); `q_proj`,
  `k_proj`, `v_proj` to `num_attention_heads` and `num_key_value_heads`
  heads of `head_dim` (the config's, else hidden_size / heads: Qwen3-0.6B
  has 16 heads of 128 on a 1024-wide model); biases on Q, K and V for
  `qwen2` always, for `qwen3` and `llama` under `attention_bias` (on
  `o_proj` too), for `mistral` never; for `qwen3` a per-head RMSNorm
  (`q_norm`, `k_norm`) over head_dim before the rotary; rotary positions
  on Q and K (models/rope.py's tables for the config's `rope_scaling`:
  `default`, `linear`, `dynamic`, `yarn`, `llama3` or `longrope`, at
  `rope_theta`, positions 0..L-1 in every row as transformers gives them
  when no position ids are passed, left-padded rows included); K and V
  repeated over `num_attention_heads // num_key_value_heads` (each KV
  head serves its group of consecutive query heads, transformers'
  `repeat_kv`); scores (Q K^T) times `head_dim ** -0.5` as a float32
  tensor on the device (fault 3.4), softmax, times V; `o_proj`; the
  residual; `post_attention_layernorm`,
  `down_proj(act(gate_proj(x)) * up_proj(x))` (`hidden_act`, one of
  models/activations.py's; biases on the three under Llama's `mlp_bias`,
  which Qwen2's, Qwen3's and Mistral's MLPs do not read), the residual;
- the final `norm`.

Key j is visible to query i iff j <= i and j is a real token; in a
sliding layer also iff i - j < `window`. Which layers slide is each
family's:
- `qwen2`, `qwen3`: `sliding_window` holds only under
  `use_sliding_window`; `layer_types` is the config's, or, as
  `Qwen2Config`/`Qwen3Config` derive it, layer i sliding iff there is a
  window and i >= `max_window_layers`;
- `mistral`: every layer slides when `sliding_window` is set (of any
  size), none when it is null;
- `llama`: no layer slides.
Where a `sliding_attention` layer has no window, transformers raises
(Qwen's mask, Llama's and Mistral's cache), and the port refuses the
config by name.

The mask replaces the scores of the keys a query does not see with
float32's lowest, never adds to them; a query with no visible key (a
left-padded row's pad tokens) gets an attention output of exactly 0, as
torch's `scaled_dot_product_attention` gives transformers by default
(hazard 3.18): not the uniform average an additive mask gives
(transformers' `eager`), and never NaN, which a zero pooling weight
would not cancel. Attention is written as explicit products and a
softmax, not `scaled_dot_product_attention`, which picks its own kernels
and rounding.

Refused by name, as transformers raises on each: `partial_rotary_factor`
(its rotary tables do not fit the head), Mistral's `dynamic`, `yarn` and
`longrope` without a `head_dim` (those tables read the None its config
stores), a `rope_scaling` models/rope.py refuses, and an activation
models/activations.py does not run.

Parameter names are transformers' (`embed_tokens.weight`,
`layers.{i}.input_layernorm.weight`,
`layers.{i}.self_attn.{q,k,v,o}_proj.{weight,bias}`,
`layers.{i}.self_attn.{q,k}_norm.weight`,
`layers.{i}.post_attention_layernorm.weight`,
`layers.{i}.mlp.{gate,up,down}_proj.{weight,bias}`, `norm.weight`), so a
checkpoint's tensors load by name (models/checkpoint.py).

Everything runs in float32. On a CUDA device the forward raises when
`torch.backends.cuda.matmul.allow_tf32` is set, as models/bert.py does.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .activations import activation
from .rope import READS_STORED_HEAD_DIM, Rope, rope_type, rotate_half

MODEL_TYPES = ("qwen3", "qwen2", "llama", "mistral")
LAYER_TYPES = ("full_attention", "sliding_attention")
# the widths a config must give (transformers' config names)
CONFIG_KEYS = ("vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers",
               "num_attention_heads")
# each family's transformers defaults for the keys its config may leave out
_COMMON = {"hidden_act": "silu", "rms_norm_eps": 1e-6, "rope_theta": 10000.0,
           "rope_scaling": None, "num_key_value_heads": None, "head_dim": None,
           "attention_bias": False, "mlp_bias": False, "layer_types": None}
_QWEN = {"num_key_value_heads": 32, "max_position_embeddings": 32_768,
         "use_sliding_window": False, "sliding_window": 4096, "max_window_layers": 28}
DEFAULTS = {
    "qwen3": {**_COMMON, **_QWEN, "head_dim": 128},
    "qwen2": {**_COMMON, **_QWEN},
    "llama": {**_COMMON, "max_position_embeddings": 2048},
    "mistral": {**_COMMON, "num_key_value_heads": 8, "max_position_embeddings": 131_072,
                "sliding_window": 4096},
}


def layer_types(kind: str, config: dict) -> tuple:
    """(layer_types, window) of a config with its defaults filled in: each
    layer's attention as the family's transformers model runs it, and the
    sliding layers' window (None if none slides)."""
    n, given = config["num_hidden_layers"], config["layer_types"]
    if given is not None and (len(given) != n or any(t not in LAYER_TYPES for t in given)):
        raise ValueError(f"layer_types {given} are not supported: the port runs {n} of"
                         f" {LAYER_TYPES}")
    if kind in ("qwen2", "qwen3"):
        window = config["sliding_window"] if config["use_sliding_window"] else None
        types = list(given) if given is not None else [
            LAYER_TYPES[window is not None and i >= config["max_window_layers"]]
            for i in range(n)]
        if "sliding_attention" in types and window is None:
            raise ValueError(f"layer_types {types} slide with no window: {kind} keeps"
                             " sliding_window only under use_sliding_window, and transformers"
                             " raises on such a config")
        return types, window
    # Llama's and Mistral's attention reads no layer_types (a Mistral window
    # slides in every layer), but transformers' cache does, and raises on a
    # sliding entry with no sliding_window
    if "sliding_attention" in (given or ()) and config.get("sliding_window") is None:
        raise ValueError(f"layer_types {given} slide with no sliding_window: transformers raises"
                         f" on such a {kind} config")
    window = config["sliding_window"] if kind == "mistral" else None
    return [LAYER_TYPES[window is not None]] * n, window


def check_config(config: dict) -> dict:
    """Raise ValueError unless `config` describes a decoder this module
    runs; return it with its family's defaults filled in,
    `num_key_value_heads` and `head_dim` resolved, and `layer_types` and
    `window` as `layer_types` gives them."""
    kind = config.get("model_type")
    if kind not in MODEL_TYPES:
        raise ValueError(f"model_type `{kind}` is not one of {MODEL_TYPES}")
    config = {**DEFAULTS[kind], **config}
    missing = [k for k in CONFIG_KEYS if k not in config]
    if missing:
        raise ValueError(f"the {kind} config lacks {missing}")
    activation(config["hidden_act"])
    if config.get("partial_rotary_factor", 1.0) != 1.0:
        raise ValueError("partial_rotary_factor is not supported: the port rotates the whole"
                         " head, and transformers' rotary for these families raises on it")
    heads = config["num_attention_heads"]
    kv = config["num_key_value_heads"] or heads
    if heads % kv:
        raise ValueError(f"num_attention_heads {heads} is not a multiple of"
                         f" num_key_value_heads {kv}")
    if config["head_dim"] is None and config["hidden_size"] % heads:
        raise ValueError("hidden_size is not a multiple of num_attention_heads")
    if kind == "mistral" and config["head_dim"] is None \
            and rope_type(config["rope_scaling"]) in READS_STORED_HEAD_DIM:
        raise ValueError(f"rope_scaling {config['rope_scaling']} is not supported for a mistral"
                         " config without head_dim: transformers' tables read the None"
                         " MistralConfig stores, and raise")
    head_dim = config["head_dim"] or config["hidden_size"] // heads
    if head_dim % 2:
        raise ValueError(f"head_dim {head_dim} is odd: the rotary embedding needs pairs")
    Rope.from_config(config, float(config["rope_theta"]), head_dim)
    types, window = layer_types(kind, config)
    return {**config, "num_key_value_heads": kv, "head_dim": head_dim, "layer_types": types,
            "window": window}


def attention_scale(head_dim: float, device: torch.device) -> torch.Tensor:
    """head_dim ** -0.5 (Gemma 3's query_pre_attn_scalar ** -0.5) as a
    float32 tensor on `device` (fault 3.4: the card multiplies by the same
    float32 the CPU does)."""
    return torch.full((), head_dim ** -0.5, dtype=torch.float32, device=device)


def blocked_keys(attention_mask: torch.Tensor, *, causal: bool,
                 window: Optional[int] = None) -> torch.Tensor:
    """(B, 1, L, L) bool, True where key j is hidden from query i, as
    transformers' masks compose (`masking_utils`): j is padding (the
    padding mask is ANDed last, after any OR), or, `causal`, j > i, or,
    with a `window`, |i - j| >= window (a causal window keeps i - j <
    window, Mistral's and Gemma-3's `sliding_window_overlay`; a
    bidirectional one |i - j| < window, Gemma-3's
    `_bidirectional_window_overlay`). A query row hidden from every key is
    one the caller zeroes after the softmax."""
    L = attention_mask.shape[1]
    rows = torch.arange(L, device=attention_mask.device)
    offset = rows[:, None] - rows[None, :]  # i - j
    hidden = attention_mask[:, None, None, :] == 0
    if causal:
        hidden = hidden | (offset < 0)
    if window is not None:
        hidden = hidden | (offset.abs() >= window)
    return hidden


class RMSNorm(nn.Module):
    def __init__(self, width: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(width))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        variance = x.pow(2).mean(-1, keepdim=True)
        return self.weight * (x * torch.rsqrt(variance + self.eps))


class Attention(nn.Module):
    """Grouped-query attention with rotary positions under a replacing
    mask (biases on Q/K/V and on O as given; `norm`: the class of the
    per-head Q/K norm, None for none). Gemma 3's stack uses it too."""

    def __init__(self, c: dict, qkv_bias: bool, o_bias: bool, norm=None):
        super().__init__()
        h, d = c["hidden_size"], c["head_dim"]
        self.heads, self.kv_heads, self.head_dim = (c["num_attention_heads"],
                                                    c["num_key_value_heads"], d)
        self.q_proj = nn.Linear(h, self.heads * d, bias=qkv_bias)
        self.k_proj = nn.Linear(h, self.kv_heads * d, bias=qkv_bias)
        self.v_proj = nn.Linear(h, self.kv_heads * d, bias=qkv_bias)
        self.o_proj = nn.Linear(self.heads * d, h, bias=o_bias)
        self.qk_norm = norm is not None
        if self.qk_norm:
            self.q_norm = norm(d, c["rms_norm_eps"])
            self.k_norm = norm(d, c["rms_norm_eps"])

    def forward(self, x: torch.Tensor, blocked: torch.Tensor, cos: torch.Tensor,
                sin: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        B, L, _ = x.shape
        q = self.q_proj(x).view(B, L, self.heads, self.head_dim)
        k = self.k_proj(x).view(B, L, self.kv_heads, self.head_dim)
        v = self.v_proj(x).view(B, L, self.kv_heads, self.head_dim).transpose(1, 2)
        if self.qk_norm:
            q, k = self.q_norm(q), self.k_norm(k)
        q, k = q.transpose(1, 2), k.transpose(1, 2)  # (B, heads, L, d)
        q = q * cos + rotate_half(q) * sin
        k = k * cos + rotate_half(k) * sin
        groups = self.heads // self.kv_heads
        if groups > 1:
            k = k.repeat_interleave(groups, dim=1)
            v = v.repeat_interleave(groups, dim=1)
        scores = torch.matmul(q, k.transpose(2, 3)) * scale
        scores = scores.masked_fill(blocked, torch.finfo(scores.dtype).min)
        probs = torch.softmax(scores, dim=-1).masked_fill(blocked, 0.0)
        out = torch.matmul(probs, v).transpose(1, 2).reshape(B, L, self.heads * self.head_dim)
        return self.o_proj(out)


class GatedMLP(nn.Module):
    """down(act(gate(x)) * up(x)) (`act`: the config's activation; biases
    on the three projections with `bias`, Llama's `mlp_bias`)."""

    def __init__(self, c: dict, act, bias: bool = False):
        super().__init__()
        h, i = c["hidden_size"], c["intermediate_size"]
        self.gate_proj = nn.Linear(h, i, bias=bias)
        self.up_proj = nn.Linear(h, i, bias=bias)
        self.down_proj = nn.Linear(i, h, bias=bias)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(self.act(self.gate_proj(x)) * self.up_proj(x))


class _Layer(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        h, eps, kind = c["hidden_size"], c["rms_norm_eps"], c["model_type"]
        qkv_bias = kind == "qwen2" or (kind in ("qwen3", "llama") and c["attention_bias"])
        o_bias = kind in ("qwen3", "llama") and c["attention_bias"]
        self.input_layernorm = RMSNorm(h, eps)
        self.self_attn = Attention(c, qkv_bias, o_bias, RMSNorm if kind == "qwen3" else None)
        self.post_attention_layernorm = RMSNorm(h, eps)
        self.mlp = GatedMLP(c, activation(c["hidden_act"]),
                            bias=kind == "llama" and c["mlp_bias"])

    def forward(self, x: torch.Tensor, blocked: torch.Tensor, cos: torch.Tensor,
                sin: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.input_layernorm(x), blocked, cos, sin, scale)
        return x + self.mlp(self.post_attention_layernorm(x))


class DecoderModel(nn.Module):
    """A Qwen3, Qwen2, Llama or Mistral decoder stack, widths from a
    transformers-style config dict (`config` holds its config's names,
    defaults filled in; `rope`, its rotary embedding)."""

    def __init__(self, config: dict):
        super().__init__()
        config = check_config(config)
        self.config = config
        self.rope = Rope.from_config(config, float(config["rope_theta"]), config["head_dim"])
        self.embed_tokens = nn.Embedding(config["vocab_size"], config["hidden_size"])
        self.layers = nn.ModuleList(_Layer(config) for _ in range(config["num_hidden_layers"]))
        self.norm = RMSNorm(config["hidden_size"], config["rms_norm_eps"])

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        """(B, L) int64 ids and 0/1 mask -> (B, L, hidden) float32, the
        last hidden state."""
        if input_ids.is_cuda and torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError(
                "the text encoder needs full float32 matmuls:"
                " torch.backends.cuda.matmul.allow_tf32 is True"
            )
        c = self.config
        x = self.embed_tokens(input_ids)
        cos, sin = self.rope.tables(input_ids.shape[1], x.device)
        blocked = {"full_attention": blocked_keys(attention_mask, causal=True)}
        if c["window"] is not None:
            blocked["sliding_attention"] = blocked_keys(attention_mask, causal=True,
                                                        window=c["window"])
        scale = attention_scale(c["head_dim"], x.device)
        for layer, kind in zip(self.layers, c["layer_types"]):
            x = layer(x, blocked[kind], cos, sin, scale)
        return self.norm(x)
