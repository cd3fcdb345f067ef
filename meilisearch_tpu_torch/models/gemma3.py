"""Gemma 3's text stack as one torch module (the port's K8 for `model_type`
`gemma3_text`: google/embeddinggemma-300m and the Gemma 3 decoders).

It computes what transformers' torch `Gemma3TextModel` computes under its
default attention (`sdpa`) on a padded batch with no cache, the model the
JAX package's encoder (`models/hf_encoder.py` there) runs through its
torch branch. It returns the last hidden state (pooling stays in
models/hf_encoder.py):

- `embed_tokens` times `hidden_size ** 0.5` rounded to float32, as
  `Gemma3TextScaledWordEmbedding` stores it;
- each layer: `input_layernorm`, attention, `post_attention_layernorm`,
  the residual; `pre_feedforward_layernorm`, the MLP
  (`down_proj(act(gate_proj(x)) * up_proj(x))`, `hidden_activation`
  one of models/activations.py's, tanh GELU by default),
  `post_feedforward_layernorm`, the residual. Every RMSNorm is
  `x * rsqrt(mean(x^2) + eps) * (1 + w)` in float32 (its weights start
  at 0);
- attention: `q_proj`, `k_proj`, `v_proj` to `num_attention_heads` and
  `num_key_value_heads` heads of `head_dim` (biases on all four
  projections under `attention_bias`), a per-head RMSNorm (`q_norm`,
  `k_norm`) over head_dim, then rotary positions (models/rope.py's
  tables: in `full_attention` layers the config's `rope_scaling` at
  `rope_theta`; in `sliding_attention` ones the default rotary at
  `rope_local_base_freq`, unscaled, as `Gemma3TextModel` builds its
  `rotary_emb_local` from a copy of the config with `rope_scaling`
  `default`; positions 0..L-1 in every row, left-padded rows
  included); K and V repeated over the query heads of their group
  (transformers' `repeat_kv`); scores times `query_pre_attn_scalar **
  -0.5` as a float32 tensor on the device (fault 3.4), softmax, times V;
  `o_proj` (models/decoder.py's `Attention` and `GatedMLP`, with Gemma's
  norm and activation);
- the final `norm`.

`layer_types` is the config's, or, as `Gemma3TextConfig` derives it,
layer i sliding unless (i + 1) is a multiple of `sliding_window_pattern`
(6: five sliding layers, then a full one). With
`use_bidirectional_attention` (EmbeddingGemma) `Gemma3TextConfig` turns
the file's `sliding_window` w into w // 2 + 1 when it is built, and this
module does the same (`window`): full layers see every real key, sliding
ones key j from query i iff |i - j| < window; a left-pad query sees the
real keys within its reach. Otherwise the stack is causal: key j is
visible iff j <= i, in sliding layers also i - j < window. Padding keys
are hidden either way. The masks (models/decoder.py's `blocked_keys`)
replace the scores of hidden keys with float32's lowest, never add to
them, and a query with no visible key gets an attention output of
exactly 0, as torch's `scaled_dot_product_attention` gives transformers
(hazard 3.18). Attention is written as explicit products and a softmax,
not `scaled_dot_product_attention`, which picks its own kernels and
rounding.

Parameter names are transformers' (`embed_tokens.weight`,
`layers.{i}.{input,post_attention,pre_feedforward,post_feedforward}_layernorm.weight`,
`layers.{i}.self_attn.{q,k,v,o}_proj.{weight,bias}`,
`layers.{i}.self_attn.{q,k}_norm.weight`,
`layers.{i}.mlp.{gate,up,down}_proj.weight`, `norm.weight`), so a
checkpoint's tensors load by name (models/checkpoint.py drops
`Gemma3ForCausalLM`'s `model.` prefix and `lm_head.`).

`attn_logit_softcapping` is accepted and ignored: transformers'
`Gemma3Attention` stores it but never passes it to the attention
function, so the reference's scores are not capped (fault 3.20).

Refused by name: the multimodal `gemma3` model type, a `rope_scaling`
models/rope.py refuses or that names its type under the older `type`
alone (Gemma3TextConfig, unlike the decoders' configs, does not rename
it), a `hidden_activation` models/activations.py does not run,
`partial_rotary_factor` (transformers' rotary raises on it), and a
`layer_types` entry other than `sliding_attention` and `full_attention`.

Everything runs in float32. On a CUDA device the forward raises when
`torch.backends.cuda.matmul.allow_tf32` is set, as models/bert.py does.
"""

from __future__ import annotations

import torch
from torch import nn

from .activations import activation
from .decoder import Attention, GatedMLP, attention_scale, blocked_keys, embed_scale
from .decoder import GemmaRMSNorm as RMSNorm
from .rope import Rope

MODEL_TYPE = "gemma3_text"
LAYER_TYPES = ("sliding_attention", "full_attention")
# the widths a config must give (transformers' config names)
CONFIG_KEYS = ("vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers",
               "num_attention_heads")
# Gemma3TextConfig's defaults for the keys a config may leave out
DEFAULTS = {"num_key_value_heads": 4, "head_dim": 256, "hidden_activation": "gelu_pytorch_tanh",
            "rms_norm_eps": 1e-6, "rope_theta": 1_000_000.0, "attention_bias": False,
            "query_pre_attn_scalar": 256, "sliding_window": 4096, "layer_types": None,
            "attn_logit_softcapping": None, "rope_scaling": None,
            "rope_local_base_freq": 10_000.0, "use_bidirectional_attention": False,
            "sliding_window_pattern": 6, "max_position_embeddings": 131_072}


def check_stack(config: dict, defaults: dict, derived_types) -> dict:
    """The checks Gemma 3's and Gemma 2's stacks share (ValueError on a
    failed one): `config` with `defaults` filled in has the widths, a
    `hidden_activation` models/activations.py runs, no
    `partial_rotary_factor` (transformers' rotary raises on it), layer
    types of LAYER_TYPES (`derived_types(config)` where it names none), a
    window for sliding layers, whole KV groups, an even head_dim and a
    rotary models/rope.py computes. Returns it with `num_key_value_heads`
    resolved and `layer_types` and `window` set."""
    kind = config["model_type"]
    config = {**defaults, **config}
    missing = [k for k in CONFIG_KEYS if k not in config]
    if missing:
        raise ValueError(f"the {kind} config lacks {missing}")
    activation(config["hidden_activation"], "hidden_activation")
    if config.get("partial_rotary_factor", 1.0) != 1.0:
        raise ValueError("partial_rotary_factor is not supported: the port rotates the whole"
                         f" head, and transformers' rotary for {kind} raises on it")
    layers = config["num_hidden_layers"]
    types = config["layer_types"]
    if types is None:
        types = derived_types(config)
    if len(types) != layers or any(t not in LAYER_TYPES for t in types):
        raise ValueError(f"layer_types {types} are not supported: the port runs {layers} of"
                         f" {LAYER_TYPES}")
    window = config["sliding_window"]
    if "sliding_attention" in types and not isinstance(window, int):
        raise ValueError(f"sliding_window {window!r} is not a number of tokens")
    heads = config["num_attention_heads"]
    kv = config["num_key_value_heads"] or heads
    if heads % kv:
        raise ValueError(f"num_attention_heads {heads} is not a multiple of"
                         f" num_key_value_heads {kv}")
    if config["head_dim"] % 2:
        raise ValueError(f"head_dim {config['head_dim']} is odd: the rotary embedding needs"
                         " pairs")
    Rope.from_config(config, float(config["rope_theta"]), config["head_dim"])
    return {**config, "num_key_value_heads": kv, "layer_types": list(types), "window": window}


def check_config(config: dict) -> dict:
    """Raise ValueError unless `config` describes a Gemma 3 text stack this
    module runs; return it with Gemma3TextConfig's defaults filled in,
    `layer_types` derived where it is missing, `window`, the sliding
    layers' reach as transformers' config object holds it, and `causal`."""
    kind = config.get("model_type")
    if kind == "gemma3":
        raise ValueError("model_type `gemma3` (Gemma3ForConditionalGeneration, text and vision)"
                         " is not supported: the port runs `gemma3_text`")
    if kind != MODEL_TYPE:
        raise ValueError(f"model_type `{kind}` is not {MODEL_TYPE}")
    scaling = config.get("rope_scaling")
    if scaling is not None and "type" in scaling and "rope_type" not in scaling:
        raise ValueError(f"rope_scaling {scaling} names its type under `type` only:"
                         " Gemma3TextConfig's validation requires `rope_type`, and raises")
    config = check_stack(config, DEFAULTS, lambda c: [
        LAYER_TYPES[(i + 1) % c["sliding_window_pattern"] == 0]
        for i in range(c["num_hidden_layers"])])
    window = config["window"]
    if window is not None and config["use_bidirectional_attention"]:
        window = window // 2 + 1  # as Gemma3TextConfig builds it
    return {**config, "window": window, "causal": not config["use_bidirectional_attention"]}


class _Layer(nn.Module):
    def __init__(self, c: dict, layer: int, qk_norm: bool):
        super().__init__()
        h, eps = c["hidden_size"], c["rms_norm_eps"]
        self.sliding = c["layer_types"][layer] == "sliding_attention"
        self.input_layernorm = RMSNorm(h, eps)
        self.self_attn = Attention(c, c["attention_bias"], c["attention_bias"],
                                   RMSNorm if qk_norm else None)
        self.post_attention_layernorm = RMSNorm(h, eps)
        self.pre_feedforward_layernorm = RMSNorm(h, eps)
        self.mlp = GatedMLP(c, activation(c["hidden_activation"]))
        self.post_feedforward_layernorm = RMSNorm(h, eps)

    def forward(self, x: torch.Tensor, blocked: torch.Tensor, cos: torch.Tensor,
                sin: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        attn = self.self_attn(self.input_layernorm(x), blocked, cos, sin, scale)
        x = x + self.post_attention_layernorm(attn)
        return x + self.post_feedforward_layernorm(self.mlp(self.pre_feedforward_layernorm(x)))


class GemmaStack(nn.Module):
    """The Gemma 3 and Gemma 2 text stacks' shared module, from a checked
    config (`qk_norm`: whether Q and K are normed per head; `local_rope`:
    the sliding layers' rotary embedding, None for `rope`)."""

    def __init__(self, config: dict, qk_norm: bool, local_rope=None):
        super().__init__()
        self.config = config
        self.rope = Rope.from_config(config, float(config["rope_theta"]), config["head_dim"])
        self.local_rope = self.rope if local_rope is None else local_rope
        self.embed_tokens = nn.Embedding(config["vocab_size"], config["hidden_size"])
        self.layers = nn.ModuleList(_Layer(config, i, qk_norm)
                                    for i in range(config["num_hidden_layers"]))
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
        L, device = input_ids.shape[1], input_ids.device
        x = self.embed_tokens(input_ids) * embed_scale(c["hidden_size"], device)
        full = (blocked_keys(attention_mask, causal=c["causal"]), *self.rope.tables(L, device))
        sliding = (blocked_keys(attention_mask, causal=c["causal"], window=c["window"]),
                   *self.local_rope.tables(L, device))
        scale = attention_scale(c["query_pre_attn_scalar"], device)
        for layer in self.layers:
            x = layer(x, *(sliding if layer.sliding else full), scale)
        return self.norm(x)


class Gemma3Model(GemmaStack):
    """A Gemma 3 text stack, widths from a transformers-style config dict
    (`config` holds Gemma3TextConfig's names, defaults filled in;
    `rope` and `local_rope`, the full and sliding layers' rotary
    embeddings)."""

    def __init__(self, config: dict):
        config = check_config(config)
        super().__init__(config, qk_norm=True, local_rope=Rope(
            "default", float(config["rope_local_base_freq"]), config["head_dim"]))
