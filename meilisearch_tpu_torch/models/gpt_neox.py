"""GPT-NeoX's forward as one torch module (the port's K8 for `model_type`
`gpt_neox`: EleutherAI's Pythia and GPT-NeoX, and the BMRetriever
embedders built on Pythia, BMRetriever/BMRetriever-410M and -1B).

It computes what transformers' torch `GPTNeoXModel` computes under its
default attention (`sdpa`) on a padded batch with no cache, the model the
JAX package's encoder (`models/hf_encoder.py` there) runs through its
torch branch (there is no Flax GPT-NeoX), and returns the last hidden
state (pooling stays in models/hf_encoder.py):

- `embed_in`; no position embedding;
- each layer: `input_layernorm` and `post_attention_layernorm`, both
  `nn.LayerNorm`s with bias. Attention on `input_layernorm(x)`: one fused
  `query_key_value` projection whose output is laid out per head, each
  head's Q, K and V side by side (`[h0: q k v][h1: q k v]...`: viewed as
  (B, L, heads, 3 x head_size) and chunked in three), not Q's block, then
  K's, then V's as Phi-3's `qkv_proj`; the rotary positions on the first
  `int(head_size * rotary_pct)` channels of each head of Q and K
  (models/rope.py's tables for `rope_scaling` at `rotary_emb_base`,
  `rotate_half` form, models/decoder.py's `rotate`), the rest passed
  through, at positions 0..L-1 in every row (`position_ids` is
  `cache_position`, counted from the padded start, not from the mask);
  scores Q K^T times `head_size ** -0.5` as a float32 tensor, models/
  decoder.py's `attend` under the causal and padding mask (a query that
  sees no key, a left pad, gives 0, as `sdpa` gives it on the CPU where
  the reference runs); `dense`. Biases on `query_key_value` and `dense`
  under `attention_bias` (default true). The MLP, not gated:
  `dense_4h_to_h(act(dense_h_to_4h(.)))` with `hidden_act` through
  models/activations.py. The residual, under `use_parallel_residual`
  (default true): `mlp(post_attention_layernorm(x)) + attn + x`, both
  norms reading the layer's input; otherwise sequential, `h = attn + x`,
  then `mlp(post_attention_layernorm(h)) + h`;
- `final_layer_norm`.

`GPTNeoXConfig` sets `rope_theta` from `rotary_emb_base` and
`partial_rotary_factor` from `rotary_pct`, after any values config.json
gives under those names: the port reads `rotary_emb_base` and
`rotary_pct`. Refused by name, as transformers raises on each: a hidden
width not a multiple of the heads, a rotary table wider than the head
(models/decoder.py's `rotary_width`), a `rope_scaling` models/rope.py
refuses (the types `GPTNeoXConfig` validates are the six it computes), and
an activation models/activations.py does not run. The rotary has no
length limit, so a batch past `max_position_embeddings` runs, as there.

Parameter names are transformers' `GPTNeoXModel`'s (`embed_in.weight`,
`layers.{i}.input_layernorm.{weight,bias}`,
`layers.{i}.post_attention_layernorm.{weight,bias}`,
`layers.{i}.attention.query_key_value.{weight,bias}`,
`layers.{i}.attention.dense.{weight,bias}`,
`layers.{i}.mlp.dense_h_to_4h.{weight,bias}`,
`layers.{i}.mlp.dense_4h_to_h.{weight,bias}`, `final_layer_norm`);
models/checkpoint.py drops `GPTNeoXForCausalLM`'s `gpt_neox.` prefix, its
`embed_out.` head and the stale `attention.bias`, `attention.masked_bias`
and `attention.rotary_emb.inv_freq` buffers older Pythia files hold.

Everything runs in float32. On a CUDA device the forward raises when
`torch.backends.cuda.matmul.allow_tf32` is set, as models/bert.py does.
"""

from __future__ import annotations

import torch
from torch import nn

from .activations import activation
from .decoder import attend, attention_scale, blocked_keys, rotary_width, rotate
from .gpt_neo import no_tf32
from .rope import Rope

MODEL_TYPE = "gpt_neox"
# GPTNeoXConfig's defaults (gpt-neox-20b's widths)
DEFAULTS = {"vocab_size": 50432, "hidden_size": 6144, "num_hidden_layers": 44,
            "num_attention_heads": 64, "intermediate_size": 24576, "hidden_act": "gelu",
            "rotary_pct": 0.25, "rotary_emb_base": 10000, "max_position_embeddings": 2048,
            "layer_norm_eps": 1e-5, "use_parallel_residual": True, "rope_scaling": None,
            "attention_bias": True}


def check_config(config: dict) -> dict:
    """Raise ValueError unless `config` describes a GPT-NeoX this module
    runs; return it with GPTNeoXConfig's defaults filled in and the
    port's names added: `head_dim` and `rotary_dim`."""
    kind = config.get("model_type")
    if kind != MODEL_TYPE:
        raise ValueError(f"model_type `{kind}` is not {MODEL_TYPE}")
    config = {**DEFAULTS, **config}
    h, heads = config["hidden_size"], config["num_attention_heads"]
    if h % heads:
        raise ValueError("hidden_size is not a multiple of num_attention_heads: GPTNeoXConfig"
                         " raises")
    activation(config["hidden_act"])
    head_dim = h // heads
    rotary_dim = rotary_width(head_dim, config["rotary_pct"], "rotary_pct")
    Rope.from_config(config, float(config["rotary_emb_base"]), rotary_dim)
    return {**config, "head_dim": head_dim, "rotary_dim": rotary_dim}


class _Attention(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        h = c["hidden_size"]
        self.heads, self.head_dim = c["num_attention_heads"], c["head_dim"]
        self.query_key_value = nn.Linear(h, 3 * h, bias=c["attention_bias"])
        self.dense = nn.Linear(h, h, bias=c["attention_bias"])

    def forward(self, x: torch.Tensor, blocked: torch.Tensor, cos: torch.Tensor,
                sin: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        B, L, _ = x.shape
        # per head: its Q, K and V side by side
        qkv = self.query_key_value(x).view(B, L, self.heads, 3 * self.head_dim).transpose(1, 2)
        q, k, v = qkv.chunk(3, dim=-1)
        q, k = rotate(q, cos, sin), rotate(k, cos, sin)
        return self.dense(attend(q, k, v, blocked, scale))


class _MLP(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        self.dense_h_to_4h = nn.Linear(c["hidden_size"], c["intermediate_size"])
        self.dense_4h_to_h = nn.Linear(c["intermediate_size"], c["hidden_size"])
        self.act = activation(c["hidden_act"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dense_4h_to_h(self.act(self.dense_h_to_4h(x)))


class _Layer(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        h, eps = c["hidden_size"], c["layer_norm_eps"]
        self.parallel = c["use_parallel_residual"]
        self.input_layernorm = nn.LayerNorm(h, eps=eps)
        self.post_attention_layernorm = nn.LayerNorm(h, eps=eps)
        self.attention = _Attention(c)
        self.mlp = _MLP(c)

    def forward(self, x: torch.Tensor, blocked: torch.Tensor, cos: torch.Tensor,
                sin: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        attn = self.attention(self.input_layernorm(x), blocked, cos, sin, scale)
        if self.parallel:
            return self.mlp(self.post_attention_layernorm(x)) + attn + x
        attn = attn + x
        return self.mlp(self.post_attention_layernorm(attn)) + attn


class GPTNeoXModel(nn.Module):
    """A GPT-NeoX stack, widths from a transformers-style config dict
    (`config` holds GPTNeoXConfig's names, defaults filled in, and
    `check_config`'s; `rope`, its rotary embedding)."""

    def __init__(self, config: dict):
        super().__init__()
        config = check_config(config)
        self.config = config
        self.rope = Rope.from_config(config, float(config["rotary_emb_base"]),
                                     config["rotary_dim"])
        h = config["hidden_size"]
        self.embed_in = nn.Embedding(config["vocab_size"], h)
        self.layers = nn.ModuleList(_Layer(config) for _ in range(config["num_hidden_layers"]))
        self.final_layer_norm = nn.LayerNorm(h, eps=config["layer_norm_eps"])

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        """(B, L) int64 ids and 0/1 mask -> (B, L, hidden) float32, the
        last hidden state."""
        no_tf32(input_ids)
        x = self.embed_in(input_ids)
        cos, sin = self.rope.tables(input_ids.shape[1], x.device)
        blocked = blocked_keys(attention_mask, causal=True)
        scale = attention_scale(self.config["head_dim"], x.device)
        for layer in self.layers:
            x = layer(x, blocked, cos, sin, scale)
        return self.final_layer_norm(x)
