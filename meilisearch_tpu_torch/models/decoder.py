"""The decoder embedders' forward as one torch module (the port's K8 for
`model_type` `qwen3`, `qwen2`, `llama`, `mistral`, `gemma` and `phi3`:
Qwen3-Embedding, gte-Qwen2, Llama, e5-mistral, Gemma and Phi-3; and the
mixture-of-experts decoders `mixtral`, `qwen2_moe` and `qwen3_moe`:
GritLM-8x7B, Qwen1.5-MoE, Qwen3-MoE).

It computes what transformers' torch `Qwen3Model`, `Qwen2Model`,
`LlamaModel`, `MistralModel`, `GemmaModel`, `Phi3Model`, `MixtralModel`,
`Qwen2MoeModel` and `Qwen3MoeModel` compute under
their default attention (`sdpa`) on a padded batch with no cache, the
models the JAX package's encoder (`models/hf_encoder.py` there) runs
through its torch branch. It returns the last hidden state (pooling
stays in models/hf_encoder.py):

- `embed_tokens`; no position embedding; for `gemma` times
  `hidden_size ** 0.5` rounded to float32 (`GemmaModel`'s normalizer);
- each layer, pre-norm: `input_layernorm`, an RMSNorm (the mean square in
  float32, `x * rsqrt(ms + eps)`, then the weight times that; Gemma's
  times `1 + w`, its weights starting at 0); `q_proj`, `k_proj`,
  `v_proj` to `num_attention_heads` and `num_key_value_heads` heads of
  `head_dim` (the config's, else hidden_size / heads: Qwen3-0.6B has 16
  heads of 128 on a 1024-wide model, gemma-7b 16 of 256 on 3,072); for
  `phi3` one fused `qkv_proj`, split as `Phi3Attention` splits it (Q's
  heads x head_dim, then K's, then V's); biases on Q, K and V for `qwen2`
  always, for `qwen3`, `llama` and `gemma` under `attention_bias` (on
  `o_proj` too), for `mistral` and `phi3` never; for `qwen3` a per-head
  RMSNorm (`q_norm`, `k_norm`) over head_dim before the rotary; rotary
  positions on Q and K (models/rope.py's tables for the config's
  `rope_scaling`: `default`, `linear`, `dynamic`, `yarn`, `llama3` or
  `longrope`, at `rope_theta`, positions 0..L-1 in every row as
  transformers gives them when no position ids are passed, left-padded
  rows included; for `phi3` over the first `int(head_dim *
  partial_rotary_factor)` channels of each head, the rest passed
  through); K and V repeated over `num_attention_heads //
  num_key_value_heads` (each KV head serves its group of consecutive
  query heads, transformers' `repeat_kv`); scores (Q K^T) times
  `head_dim ** -0.5` as a float32 tensor on the device (fault 3.4),
  softmax, times V; `o_proj`; the residual; `post_attention_layernorm`,
  `down_proj(act(gate_proj(x)) * up_proj(x))` (`hidden_act`, one of
  models/activations.py's, for `gemma` too, whose `hidden_activation`
  nothing reads; biases on the three under Llama's `mlp_bias`, which the
  other families' MLPs do not read; for `phi3` one fused `gate_up_proj`,
  its first half the gate, `Phi3MLP`'s `chunk(2)`), the residual; for
  the MoE types models/moe.py's sparse block instead where
  `moe.is_sparse` says so (`block_sparse_moe` in every Mixtral layer;
  `mlp` in a Qwen MoE layer, a `GatedMLP` at `intermediate_size` in the
  others);
- the final `norm`.

The MoE types' attention: `mixtral` Mistral's (no biases, 8 KV heads,
`rope_theta` 1e6 and `rms_norm_eps` 1e-5 by default); `qwen3_moe`
Qwen3's (Q/K norms, biases on Q, K, V and O under `attention_bias`);
`qwen2_moe` Qwen2's with biases on Q, K and V under `qkv_bias` (none on
O), a head_dim of hidden_size / heads (another raises there), and its own
mask: `Qwen2MoeModel._update_causal_mask` adds float32's lowest for the
hidden keys, and on the CPU, where the reference runs, leaves a row that
sees no key (a left pad's) to the softmax, which averages all L values
uniformly. The port computes that on every device (transformers would
unmask such rows on a CUDA device, which the reference never is).

Key j is visible to query i iff j <= i and j is a real token; in a
sliding layer also iff i - j < `window`. Which layers slide is each
family's:
- `qwen2`, `qwen3`: `sliding_window` holds only under
  `use_sliding_window`; `layer_types` is the config's, or, as
  `Qwen2Config`/`Qwen3Config` derive it, layer i sliding iff there is a
  window and i >= `max_window_layers`;
- `mistral`, `phi3`, `mixtral`: every layer slides when `sliding_window`
  is set (of any size), none when it is null;
- `qwen2_moe`, `qwen3_moe`: every layer slides when `use_sliding_window`
  keeps a `sliding_window` (their configs drop it otherwise), whatever
  `layer_types` or `max_window_layers` say (their masks read neither);
- `llama`, `gemma`: no layer slides.
Where a `sliding_attention` layer has no window, transformers raises
(Qwen's mask, the others' cache), and the port refuses the config by
name.

The mask replaces the scores of the keys a query does not see with
float32's lowest, never adds to them; a query with no visible key (a
left-padded row's pad tokens) gets an attention output of exactly 0
(but for `qwen2_moe`, above), as
torch's `scaled_dot_product_attention` gives transformers by default
(hazard 3.18): not the uniform average an additive mask gives
(transformers' `eager`), and never NaN, which a zero pooling weight
would not cancel. Attention is written as explicit products and a
softmax, not `scaled_dot_product_attention`, which picks its own kernels
and rounding.

Refused by name, as transformers raises on each: `partial_rotary_factor`
for every family but `phi3` (their rotary tables do not fit the head),
and for `phi3` one whose tables are wider than the head (an odd rotated
width w runs as transformers runs it: w's frequencies, over w + 1
channels; a width of 0 rotates nothing);
Phi-3's `rope_scaling` other than the three fields `Phi3Config`
validates (`type` `longrope`, or `su` or `yarn`, which it renames so,
`short_factor` and `long_factor` of `int(hidden_size / heads *
partial_rotary_factor) // 2` numbers); Mistral's `dynamic`, `yarn` and
`longrope` without a `head_dim` (those tables read the None its config
stores; Mixtral's too), a `rope_scaling` models/rope.py refuses, an
activation models/activations.py does not run, a `qwen2_moe` head_dim
other than hidden_size / heads, and what models/moe.py refuses.
`router_jitter_noise` and `output_router_logits` act only in training or
on outputs the encoder drops, and are read as eval reads them: not at
all.

Parameter names are transformers' (`embed_tokens.weight`,
`layers.{i}.input_layernorm.weight`,
`layers.{i}.self_attn.{q,k,v,o}_proj.{weight,bias}`,
`layers.{i}.self_attn.qkv_proj.weight`,
`layers.{i}.self_attn.{q,k}_norm.weight`,
`layers.{i}.post_attention_layernorm.weight`,
`layers.{i}.mlp.{gate,up,down}_proj.{weight,bias}`,
`layers.{i}.mlp.gate_up_proj.weight`, models/moe.py's under
`layers.{i}.block_sparse_moe.` or `layers.{i}.mlp.`, `norm.weight`), so a checkpoint's
tensors load by name (models/checkpoint.py; Phi-3's fused projections
stay fused, at the reference's product shapes).

Everything runs in float32. On a CUDA device the forward raises when
`torch.backends.cuda.matmul.allow_tf32` is set, as models/bert.py does.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from . import moe
from .activations import activation
from .rope import READS_STORED_HEAD_DIM, Rope, rope_type, rotate_half

MODEL_TYPES = ("qwen3", "qwen2", "llama", "mistral", "gemma", "phi3", *moe.MODEL_TYPES)
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
_QWEN_MOE = {**_QWEN, "decoder_sparse_step": 1, "norm_topk_prob": False, "mlp_only_layers": [],
             "output_router_logits": False}
DEFAULTS = {
    "qwen3": {**_COMMON, **_QWEN, "head_dim": 128},
    "qwen2": {**_COMMON, **_QWEN},
    "llama": {**_COMMON, "max_position_embeddings": 2048},
    "mistral": {**_COMMON, "num_key_value_heads": 8, "max_position_embeddings": 131_072,
                "sliding_window": 4096},
    "gemma": {**_COMMON, "hidden_act": "gelu_pytorch_tanh", "num_key_value_heads": 16,
              "head_dim": 256, "max_position_embeddings": 8192},
    "phi3": {**_COMMON, "rms_norm_eps": 1e-5, "max_position_embeddings": 4096,
             "original_max_position_embeddings": 4096, "partial_rotary_factor": 1.0,
             "sliding_window": None},
    # MixtralConfig's, Qwen2MoeConfig's and Qwen3MoeConfig's
    moe.MIXTRAL: {**_COMMON, "rms_norm_eps": 1e-5, "rope_theta": 1e6, "num_key_value_heads": 8,
                  "max_position_embeddings": 131_072, "sliding_window": None,
                  "num_local_experts": 8, "num_experts_per_tok": 2, "router_jitter_noise": 0.0,
                  "output_router_logits": False},
    moe.QWEN2_MOE: {**_COMMON, **_QWEN_MOE, "num_key_value_heads": 16, "num_experts": 60,
                    "num_experts_per_tok": 4, "moe_intermediate_size": 1408,
                    "shared_expert_intermediate_size": 5632, "qkv_bias": True},
    moe.QWEN3_MOE: {**_COMMON, **_QWEN_MOE, "num_key_value_heads": 4, "num_experts": 128,
                    "num_experts_per_tok": 8, "moe_intermediate_size": 768},
}
# families whose every layer slides when the config has a window
_ALWAYS_SLIDING = ("mistral", "phi3", moe.MIXTRAL)
# Mistral's and Mixtral's configs store a head_dim of None
_STORED_NONE_HEAD_DIM = ("mistral", moe.MIXTRAL)
# the rope types Phi3Config renames to `longrope`
_PHI3_LONGROPE = ("longrope", "su", "yarn")


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
    if kind in (moe.QWEN2_MOE, moe.QWEN3_MOE):
        window = config["sliding_window"] if config["use_sliding_window"] else None
        return [LAYER_TYPES[window is not None]] * n, window
    # the other families' attention reads no layer_types (a Mistral or
    # Phi-3 window slides in every layer), but transformers' cache does,
    # and raises on a sliding entry with no sliding_window
    if "sliding_attention" in (given or ()) and config.get("sliding_window") is None:
        raise ValueError(f"layer_types {given} slide with no sliding_window: transformers raises"
                         f" on such a {kind} config")
    window = config["sliding_window"] if kind in _ALWAYS_SLIDING else None
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
    if kind in (moe.QWEN2_MOE, moe.QWEN3_MOE) and config["mlp_only_layers"] is None:
        config["mlp_only_layers"] = []  # the configs' own default
    missing = [k for k in CONFIG_KEYS if k not in config]
    if missing:
        raise ValueError(f"the {kind} config lacks {missing}")
    activation(config["hidden_act"])
    factor = config.get("partial_rotary_factor", 1.0)
    if kind != "phi3" and factor != 1.0:
        raise ValueError(f"partial_rotary_factor is not supported for {kind}: the port rotates"
                         " the whole head, and transformers' rotary for this family raises on"
                         " it")
    heads = config["num_attention_heads"]
    kv = config["num_key_value_heads"] or heads
    if heads % kv:
        raise ValueError(f"num_attention_heads {heads} is not a multiple of"
                         f" num_key_value_heads {kv}")
    if config["head_dim"] is None and config["hidden_size"] % heads:
        raise ValueError("hidden_size is not a multiple of num_attention_heads")
    if kind in _STORED_NONE_HEAD_DIM and config["head_dim"] is None \
            and rope_type(config["rope_scaling"]) in READS_STORED_HEAD_DIM:
        raise ValueError(f"rope_scaling {config['rope_scaling']} is not supported for a {kind}"
                         " config without head_dim: transformers' tables read the None its"
                         " config stores, and raise")
    if kind == moe.QWEN2_MOE and config["head_dim"] is not None \
            and config["head_dim"] * heads != config["hidden_size"]:
        raise ValueError(f"head_dim {config['head_dim']} is not supported for qwen2_moe: its"
                         " attention raises unless head_dim x heads is hidden_size")
    head_dim = config["head_dim"] or config["hidden_size"] // heads
    rotary_dim = rotary_width(head_dim, factor)
    if kind == "phi3":
        config = {**config, "rope_scaling": phi3_rope_scaling(config)}
    Rope.from_config(config, float(config["rope_theta"]), rotary_dim)
    types, window = layer_types(kind, config)
    if kind in moe.MODEL_TYPES:
        moe.check_config(config)
    return {**config, "num_key_value_heads": kv, "head_dim": head_dim,
            "rotary_dim": rotary_dim, "layer_types": types, "window": window}


def rotary_width(head_dim: int, factor: float, key: str = "partial_rotary_factor") -> int:
    """The rotated channels of a head, `int(head_dim * factor)` (`factor`:
    the config's `key`), as transformers' rotary tables take them. The
    tables hold that width's frequencies twice over, so an odd width
    rotates one channel more (Phi-3 and GPT-NeoX run that); a whole odd
    head has no channel to spare, and a table wider than the head raises
    ValueError, as transformers' rotary does."""
    rotary_dim = int(head_dim * factor)
    if rotary_dim + rotary_dim % 2 > head_dim:
        raise ValueError(f"head_dim {head_dim} does not hold the rotary tables' "
                         f"{rotary_dim + rotary_dim % 2} channels ({key} {factor}):"
                         " transformers' rotary raises on it")
    return rotary_dim


def phi3_rope_scaling(config: dict) -> Optional[dict]:
    """A Phi-3 config's `rope_scaling` as models/rope.py reads it (None, or
    `longrope` with its two factor lists), after `Phi3Config`'s own
    checks: None, or exactly `type`, `short_factor` and `long_factor`,
    `type` `longrope` (`su` and `yarn` renamed so), each list
    `int(hidden_size // heads * partial_rotary_factor) // 2` numbers long.
    Anything else raises ValueError, as `Phi3Config` does."""
    scaling = config["rope_scaling"]
    if scaling is None:
        return None
    if not isinstance(scaling, dict) or len(scaling) != 3 \
            or scaling.get("type") not in _PHI3_LONGROPE:
        raise ValueError(f"rope_scaling {scaling} is not supported for phi3: Phi3Config takes"
                         " only the three fields `type` (longrope), `short_factor` and"
                         " `long_factor`, and raises")
    rotated = int(config["hidden_size"] // config["num_attention_heads"]
                  * config["partial_rotary_factor"])
    for key in ("short_factor", "long_factor"):
        value = scaling.get(key)
        if not (isinstance(value, list) and all(isinstance(x, (int, float)) for x in value)
                and len(value) == rotated // 2):
            raise ValueError(f"rope_scaling's {key} is not a list of {rotated // 2} numbers:"
                             " Phi3Config raises")
    return {"rope_type": "longrope", "short_factor": scaling["short_factor"],
            "long_factor": scaling["long_factor"]}


def embed_scale(hidden: int, device: torch.device) -> torch.Tensor:
    """hidden ** 0.5 rounded to float32 on `device`: Gemma's normalizer, as
    `GemmaModel` computes it and Gemma3TextScaledWordEmbedding stores it."""
    return torch.full((), hidden ** 0.5, dtype=torch.float32, device=device)


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


class GemmaRMSNorm(nn.Module):
    """Gemma's RMSNorm: x * rsqrt(mean(x^2) + eps) * (1 + w), w from 0."""

    def __init__(self, width: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(width))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        normed = x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + self.eps)
        return normed * (1.0 + self.weight)


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotary positions on the first cos.shape[-1] channels of x, the rest
    passed through (transformers' `apply_rotary_pos_emb`; Phi-3's partial
    rotary)."""
    rotated = cos.shape[-1]
    if rotated == x.shape[-1]:
        return x * cos + rotate_half(x) * sin
    x_rot, x_pass = x[..., :rotated], x[..., rotated:]
    return torch.cat((x_rot * cos + rotate_half(x_rot) * sin, x_pass), dim=-1)


class Attention(nn.Module):
    """Grouped-query attention with rotary positions under a replacing
    mask (biases on Q/K/V and on O as given; `norm`: the class of the
    per-head Q/K norm, None for none; `fused`: Phi-3's one `qkv_proj`).
    Gemma 3's and Gemma 2's stacks use it too."""

    def __init__(self, c: dict, qkv_bias: bool, o_bias: bool, norm=None, fused: bool = False,
                 zero_unseen: bool = True):
        super().__init__()
        # zero a query's output where it sees no key (sdpa's), else leave
        # the softmax's uniform average over the lowest scores (an additive
        # mask's, Qwen2-MoE's on the CPU)
        self.zero_unseen = zero_unseen
        h, d = c["hidden_size"], c["head_dim"]
        self.heads, self.kv_heads, self.head_dim = (c["num_attention_heads"],
                                                    c["num_key_value_heads"], d)
        self.fused = fused
        if fused:
            self.qkv_proj = nn.Linear(h, (self.heads + 2 * self.kv_heads) * d, bias=qkv_bias)
        else:
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
        d = self.head_dim
        if self.fused:
            q, k, v = self.qkv_proj(x).split(
                (self.heads * d, self.kv_heads * d, self.kv_heads * d), dim=-1)
        else:
            q, k, v = self.q_proj(x), self.k_proj(x), self.v_proj(x)
        q = q.view(B, L, self.heads, d)
        k = k.view(B, L, self.kv_heads, d)
        v = v.view(B, L, self.kv_heads, d).transpose(1, 2)
        if self.qk_norm:
            q, k = self.q_norm(q), self.k_norm(k)
        q, k = q.transpose(1, 2), k.transpose(1, 2)  # (B, heads, L, d)
        q, k = rotate(q, cos, sin), rotate(k, cos, sin)
        groups = self.heads // self.kv_heads
        if groups > 1:
            k = k.repeat_interleave(groups, dim=1)
            v = v.repeat_interleave(groups, dim=1)
        return self.o_proj(attend(q, k, v, blocked, scale, self.zero_unseen))


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, blocked: torch.Tensor,
           scale: torch.Tensor, zero_unseen: bool = True) -> torch.Tensor:
    """Attention over (B, heads, L, d) Q, K and V under `blocked_keys`' mask:
    scores Q K^T times `scale`, the blocked ones replaced by float32's
    lowest, the softmax (its blocked probabilities zeroed with
    `zero_unseen`, so a query that sees no key gives 0, as `sdpa` does),
    times V. Returns (B, L, heads x d)."""
    B, heads, L, d = q.shape
    scores = torch.matmul(q, k.transpose(2, 3)) * scale
    scores = scores.masked_fill(blocked, torch.finfo(scores.dtype).min)
    probs = torch.softmax(scores, dim=-1)
    if zero_unseen:
        probs = probs.masked_fill(blocked, 0.0)
    return torch.matmul(probs, v).transpose(1, 2).reshape(B, L, heads * d)


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


class FusedGatedMLP(nn.Module):
    """Phi-3's MLP: gate, up = gate_up_proj(x).chunk(2), then
    down(up * act(gate)), no biases."""

    def __init__(self, c: dict, act):
        super().__init__()
        h, i = c["hidden_size"], c["intermediate_size"]
        self.gate_up_proj = nn.Linear(h, 2 * i, bias=False)
        self.down_proj = nn.Linear(i, h, bias=False)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gate, up = self.gate_up_proj(x).chunk(2, dim=-1)
        return self.down_proj(up * self.act(gate))


class _Layer(nn.Module):
    def __init__(self, c: dict, index: int):
        super().__init__()
        h, eps, kind = c["hidden_size"], c["rms_norm_eps"], c["model_type"]
        biased = kind in ("qwen3", "llama", "gemma", moe.QWEN3_MOE) and c["attention_bias"]
        qkv_bias = kind == "qwen2" or biased or (kind == moe.QWEN2_MOE and c["qkv_bias"])
        norm = GemmaRMSNorm if kind == "gemma" else RMSNorm
        act = activation(c["hidden_act"])
        self.input_layernorm = norm(h, eps)
        self.self_attn = Attention(c, qkv_bias, biased,
                                   RMSNorm if kind in ("qwen3", moe.QWEN3_MOE) else None,
                                   fused=kind == "phi3", zero_unseen=kind != moe.QWEN2_MOE)
        self.post_attention_layernorm = norm(h, eps)
        # the feed-forward's name in the checkpoint: Mixtral's block_sparse_moe
        self.ffn = "block_sparse_moe" if kind == moe.MIXTRAL else "mlp"
        if kind in moe.MODEL_TYPES and moe.is_sparse(c, index):
            ffn = moe.SparseMoeBlock(c, act)
        elif kind == "phi3":
            ffn = FusedGatedMLP(c, act)
        else:
            ffn = GatedMLP(c, act, bias=kind == "llama" and c["mlp_bias"])
        setattr(self, self.ffn, ffn)

    def forward(self, x: torch.Tensor, blocked: torch.Tensor, cos: torch.Tensor,
                sin: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.input_layernorm(x), blocked, cos, sin, scale)
        return x + getattr(self, self.ffn)(self.post_attention_layernorm(x))


class DecoderModel(nn.Module):
    """A Qwen3, Qwen2, Llama, Mistral, Gemma, Phi-3, Mixtral, Qwen2-MoE or
    Qwen3-MoE decoder stack, widths
    from a transformers-style config dict (`config` holds its config's
    names, defaults filled in; `rope`, its rotary embedding)."""

    def __init__(self, config: dict):
        super().__init__()
        config = check_config(config)
        self.config = config
        self.rope = Rope.from_config(config, float(config["rope_theta"]), config["rotary_dim"])
        self.embed_tokens = nn.Embedding(config["vocab_size"], config["hidden_size"])
        self.layers = nn.ModuleList(_Layer(config, i) for i in range(config["num_hidden_layers"]))
        norm = GemmaRMSNorm if config["model_type"] == "gemma" else RMSNorm
        self.norm = norm(config["hidden_size"], config["rms_norm_eps"])

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
        if c["model_type"] == "gemma":
            x = x * embed_scale(c["hidden_size"], x.device)
        cos, sin = self.rope.tables(input_ids.shape[1], x.device)
        blocked = {"full_attention": blocked_keys(attention_mask, causal=True)}
        if c["window"] is not None:
            blocked["sliding_attention"] = blocked_keys(attention_mask, causal=True,
                                                        window=c["window"])
        scale = attention_scale(c["head_dim"], x.device)
        for layer, kind in zip(self.layers, c["layer_types"]):
            x = layer(x, blocked[kind], cos, sin, scale)
        return self.norm(x)
