"""ModernBERT's encoder forward as a torch module (the port's K8 for
`model_type` `modernbert`: answerdotai/ModernBERT-base and the embedding
models built on it).

It computes what transformers' torch `ModernBertModel` computes in its
`eager`/`sdpa` branch (padded batches, no unpadding), the model the JAX
package's encoder (`models/hf_encoder.py` there) runs through its torch
branch, since transformers has no Flax ModernBERT. It returns the last
hidden state (pooling stays in models/hf_encoder.py):

- embeddings: `tok_embeddings`, then a LayerNorm (`norm_eps`, a bias only
  with `norm_bias`); no position or token-type embedding; dropout is off;
- each layer, pre-norm: `attn_norm` (the identity in layer 0), then
  `Wqkv` split into (B, L, 3, heads, d); rotary positions on Q and K
  (`rotate_half`; cos and sin of `inv_freq @ positions`, positions 0..L-1
  in every row, `inv_freq = 1 / theta ** (arange(0, d, 2) / d)`, all in
  float32 and on the host with transformers' own ops at its shapes, so
  they are the same bits on every device: models/rope.py's `rotary`);
  scores (Q K^T) * d^-0.5 plus the layer's additive mask, softmax, times
  V; `Wo`; the residual; then
  `mlp_norm`, `Wi` split in two halves, exact (erf) GELU of the first
  times the second (GeGLU), `Wo`, the residual;
- layer types: layer i is global when i % `global_attn_every_n_layers` is
  0 (rotary theta `global_rope_theta`, the padding mask alone), local
  otherwise (theta `local_rope_theta`, or the global one when that is
  null; keys farther than `local_attention` // 2 from the query masked
  too);
- `final_norm` closes the stack.

The masks replace values, as transformers' `_update_attention_mask`
does: each is 0 or finfo(float32).min, never the sum of two biases (min +
min is -inf, a padded row whose window is all padding would then softmax
to NaN, and its V, weighted 0 by the real rows, would carry the NaN into
them). Attention is written as explicit products and a softmax, not
`scaled_dot_product_attention`, which picks its own kernels and rounding.

Parameter names are transformers' `ModernBertModel` names
(`embeddings.tok_embeddings.weight`, `embeddings.norm.weight`,
`layers.{i}.attn_norm.weight` for i >= 1, `layers.{i}.attn.Wqkv.weight`,
`layers.{i}.attn.Wo.weight`, `layers.{i}.mlp_norm.weight`,
`layers.{i}.mlp.Wi.weight`, `layers.{i}.mlp.Wo.weight`,
`final_norm.weight`; biases only where `norm_bias`, `attention_bias` and
`mlp_bias` say), so a checkpoint's tensors load by name
(models/checkpoint.py).

Everything runs in float32. On a CUDA device the forward raises when
`torch.backends.cuda.matmul.allow_tf32` is set, as models/bert.py does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .rope import rotary, rotate_half

# the widths and flags a config must give (transformers' ModernBertConfig
# names; its defaults are answerdotai/ModernBERT-base's)
CONFIG_KEYS = (
    "vocab_size",
    "hidden_size",
    "intermediate_size",
    "num_hidden_layers",
    "num_attention_heads",
    "norm_eps",
    "global_attn_every_n_layers",
    "local_attention",
    "global_rope_theta",
    "pad_token_id",
)
DEFAULTS = {"norm_bias": False, "attention_bias": False, "mlp_bias": False,
            "hidden_activation": "gelu", "local_rope_theta": 10000.0}


def check_config(config: dict) -> dict:
    """Raise ValueError unless `config` describes a ModernBERT this module
    runs; return it with ModernBertConfig's defaults filled in."""
    if config.get("model_type") != "modernbert":
        raise ValueError(f"model_type `{config.get('model_type')}` is not modernbert")
    config = {**DEFAULTS, **config}
    missing = [k for k in CONFIG_KEYS if k not in config]
    if missing:
        raise ValueError(f"the modernbert config lacks {missing}")
    if config["hidden_activation"] != "gelu":
        raise ValueError(f"hidden_activation `{config['hidden_activation']}` is not supported:"
                         " the port runs exact GELU only")
    rope = config.get("rope_scaling")
    if rope is not None and (rope.get("rope_type", rope.get("type")) or "default") != "default":
        raise ValueError(f"rope_scaling {rope} is not supported: the port runs the default"
                         " rotary embedding only")
    if config.get("partial_rotary_factor", 1.0) != 1.0:
        raise ValueError("partial_rotary_factor is not supported: the port rotates the whole"
                         " head")
    if config["hidden_size"] % config["num_attention_heads"]:
        raise ValueError("hidden_size is not a multiple of num_attention_heads")
    head_dim = config["hidden_size"] // config["num_attention_heads"]
    if config.get("head_dim") not in (None, head_dim):
        raise ValueError(f"head_dim {config['head_dim']} is not supported: the port's heads"
                         f" are hidden_size / num_attention_heads = {head_dim} wide")
    return config


def is_global(config: dict, layer: int) -> bool:
    """Whether layer `layer` attends globally (else in a sliding window)."""
    return layer % config["global_attn_every_n_layers"] == 0


def layer_theta(config: dict, layer: int) -> float:
    if is_global(config, layer) or config["local_rope_theta"] is None:
        return config["global_rope_theta"]
    return config["local_rope_theta"]


class _Embeddings(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        self.tok_embeddings = nn.Embedding(c["vocab_size"], c["hidden_size"])
        self.norm = nn.LayerNorm(c["hidden_size"], eps=c["norm_eps"], bias=c["norm_bias"])

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.norm(self.tok_embeddings(input_ids))


class _Attention(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        h = c["hidden_size"]
        self.heads = c["num_attention_heads"]
        self.Wqkv = nn.Linear(h, 3 * h, bias=c["attention_bias"])
        self.Wo = nn.Linear(h, h, bias=c["attention_bias"])

    def forward(self, x: torch.Tensor, mask: torch.Tensor, cos: torch.Tensor,
                sin: torch.Tensor) -> torch.Tensor:
        B, L, h = x.shape
        d = h // self.heads
        qkv = self.Wqkv(x).view(B, L, 3, self.heads, d)
        q, k, v = qkv.transpose(3, 1).unbind(dim=2)  # (B, heads, L, d) each
        q = q * cos + rotate_half(q) * sin
        k = k * cos + rotate_half(k) * sin
        scores = torch.matmul(q, k.transpose(2, 3)) * d ** -0.5
        probs = torch.softmax(scores + mask, dim=-1)
        out = torch.matmul(probs, v).transpose(1, 2).contiguous().view(B, L, h)
        return self.Wo(out)


class _MLP(nn.Module):
    """GeGLU: Wi to two halves, gelu(first) * second, Wo."""

    def __init__(self, c: dict):
        super().__init__()
        h, i = c["hidden_size"], c["intermediate_size"]
        self.Wi = nn.Linear(h, 2 * i, bias=c["mlp_bias"])
        self.Wo = nn.Linear(i, h, bias=c["mlp_bias"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inp, gate = self.Wi(x).chunk(2, dim=-1)
        return self.Wo(F.gelu(inp) * gate)  # exact (erf) GELU


class _Layer(nn.Module):
    def __init__(self, c: dict, layer: int):
        super().__init__()
        h = c["hidden_size"]
        self.attn_norm = (nn.Identity() if layer == 0
                          else nn.LayerNorm(h, eps=c["norm_eps"], bias=c["norm_bias"]))
        self.attn = _Attention(c)
        self.mlp_norm = nn.LayerNorm(h, eps=c["norm_eps"], bias=c["norm_bias"])
        self.mlp = _MLP(c)

    def forward(self, x: torch.Tensor, mask: torch.Tensor, cos: torch.Tensor,
                sin: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.attn_norm(x), mask, cos, sin)
        return x + self.mlp(self.mlp_norm(x))


class ModernBertModel(nn.Module):
    """ModernBERT's encoder stack, widths from a transformers-style config
    dict (`config` holds ModernBertConfig's names, defaults filled in)."""

    def __init__(self, config: dict):
        super().__init__()
        config = check_config(config)
        self.config = config
        self.embeddings = _Embeddings(config)
        self.layers = nn.ModuleList(_Layer(config, i) for i in range(config["num_hidden_layers"]))
        self.final_norm = nn.LayerNorm(config["hidden_size"], eps=config["norm_eps"],
                                       bias=config["norm_bias"])

    def masks(self, attention_mask: torch.Tensor, dtype: torch.dtype) -> tuple:
        """(global, local) additive masks: (B, 1, 1, L) with 0 on real keys
        and dtype's lowest on padded ones; (B, 1, L, L) with the lowest on
        padded keys and on keys farther than local_attention // 2 from the
        query too."""
        device, L = attention_mask.device, attention_mask.shape[1]
        zero = torch.zeros((), dtype=dtype, device=device)
        low = torch.full((), torch.finfo(dtype).min, dtype=dtype, device=device)
        real = attention_mask[:, None, None, :] > 0
        rows = torch.arange(L, device=device)
        window = (rows[None, :] - rows[:, None]).abs() <= self.config["local_attention"] // 2
        return torch.where(real, zero, low), torch.where(real & window, zero, low)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        """(B, L) int64 ids and 0/1 mask -> (B, L, hidden) float32, the
        last hidden state."""
        if input_ids.is_cuda and torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError(
                "the text encoder needs full float32 matmuls:"
                " torch.backends.cuda.matmul.allow_tf32 is True"
            )
        c = self.config
        x = self.embeddings(input_ids)
        L, d = input_ids.shape[1], c["hidden_size"] // c["num_attention_heads"]
        global_mask, local_mask = self.masks(attention_mask, x.dtype)
        for i, layer in enumerate(self.layers):
            cos, sin = rotary(L, d, float(layer_theta(c, i)), x.device)
            mask = global_mask if is_global(c, i) else local_mask
            x = layer(x, mask, cos, sin)
        return self.final_norm(x)
