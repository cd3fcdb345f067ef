"""Gemma 2's stack as one torch module (the port's K8 for `model_type`
`gemma2`: BAAI/bge-multilingual-gemma2 and the Gemma 2 decoders).

It computes what transformers' torch `Gemma2Model` computes under its
default attention (`sdpa`) on a padded batch with no cache, the model the
JAX package's encoder (`models/hf_encoder.py` there) runs through its
torch branch, and returns the last hidden state. It is Gemma 3's text
stack (models/gemma3.py's `GemmaStack`: the scaled embedding, the four
`(1 + w)` RMSNorms a layer, GQA, the gated MLP of `hidden_activation`,
scores times `query_pre_attn_scalar ** -0.5`, the final norm) with these
differences:

- no per-head `q_norm` or `k_norm`;
- one rotary embedding for every layer, at `rope_theta` under the
  config's `rope_scaling` (models/rope.py; `Gemma2Config` validates none,
  so a `type` alone names the type), and no local base;
- causal attention only: key j is visible to query i iff j <= i and j is
  a real token, in a `sliding_attention` layer also iff i - j <
  `sliding_window`;
- `layer_types` is the config's, or, as `Gemma2Config` derives it, layer
  i sliding iff (i + 1) is odd (sliding, full, sliding, ...).

`query_pre_attn_scalar` need not be `head_dim` (gemma-2-27b's is 144).
`attn_logit_softcapping` is accepted and ignored: transformers' `sdpa`
attention, which `AutoModel` picks, drops the cap that only its `eager`
function applies (fault 3.20, as for Gemma 3). `final_logit_softcapping`
belongs to the LM head, which is not loaded.

Refused by name, as transformers raises on each: `partial_rotary_factor`
(its rotary tables do not fit the head), a `rope_scaling`
models/rope.py refuses, a `hidden_activation` models/activations.py does
not run, a `layer_types` entry other than `sliding_attention` and
`full_attention`, and sliding layers without a window.

Parameter names are transformers' (those of models/gemma3.py without
`q_norm` and `k_norm`), so a checkpoint's tensors load by name
(models/checkpoint.py drops `Gemma2ForCausalLM`'s `model.` prefix and
`lm_head.`).

Everything runs in float32. On a CUDA device the forward raises when
`torch.backends.cuda.matmul.allow_tf32` is set, as models/bert.py does.
"""

from __future__ import annotations

from .gemma3 import LAYER_TYPES, GemmaStack, check_stack

MODEL_TYPE = "gemma2"
# Gemma2Config's defaults for the keys a config may leave out
DEFAULTS = {"num_key_value_heads": 4, "head_dim": 256, "hidden_activation": "gelu_pytorch_tanh",
            "rms_norm_eps": 1e-6, "rope_theta": 10_000.0, "attention_bias": False,
            "query_pre_attn_scalar": 256, "sliding_window": 4096, "layer_types": None,
            "attn_logit_softcapping": 50.0, "final_logit_softcapping": 30.0,
            "rope_scaling": None, "max_position_embeddings": 8192}


def check_config(config: dict) -> dict:
    """Raise ValueError unless `config` describes a Gemma 2 stack this
    module runs (models/gemma3.py's `check_stack`); return it with
    Gemma2Config's defaults filled in, `layer_types` derived where it is
    missing (layer i sliding iff (i + 1) is odd), `window` (the sliding
    layers' reach) and `causal` (always)."""
    kind = config.get("model_type")
    if kind != MODEL_TYPE:
        raise ValueError(f"model_type `{kind}` is not {MODEL_TYPE}")
    config = check_stack(config, DEFAULTS, lambda c: [
        LAYER_TYPES[not (i + 1) % 2] for i in range(c["num_hidden_layers"])])
    return {**config, "causal": True}


class Gemma2Model(GemmaStack):
    """A Gemma 2 stack, widths from a transformers-style config dict
    (`config` holds Gemma2Config's names, defaults filled in; `rope`, the
    one rotary embedding of every layer)."""

    def __init__(self, config: dict):
        super().__init__(check_config(config), qk_norm=False)
