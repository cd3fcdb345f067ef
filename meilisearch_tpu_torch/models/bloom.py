"""BLOOM's forward as one torch module (the port's K8 for `model_type`
`bloom`: bigscience's BLOOM and the embedders built on it,
bigscience/sgpt-bloom-7b1-msmarco and izhx/udever-bloom-560m to -7b1).

It computes what transformers' torch `BloomModel` computes under its only
attention for an embedding call (`eager`) on a padded batch, the model
the JAX package's encoder (`models/hf_encoder.py` there) runs through its
torch branch, and returns the last hidden state:

- `word_embeddings`, then `word_embeddings_layernorm`; no position
  embedding;
- ALiBi (`build_alibi_tensor`): one slope a head, `2 ** (-(2 ** -(log2(n)
  - 3)))` to the powers 1..n for the largest power of two n <= heads, and
  for the heads past n the odd powers of the next base up; each key's
  bias is its slope times `(cumsum(mask) - 1) * mask`, the key's index
  counted from its text's first real token (0 on pads), the same for
  every query;
- each layer: `input_layernorm`; the fused `query_key_value` laid out
  per head, (heads, 3, head_dim) (`_reshape`), not (3, heads, head_dim);
  scores `baddbmm(alibi, Q, K^T, beta=1, alpha=1/sqrt(head_dim))`, plus
  the additive causal and padding mask (models/gpt_neo.py's
  `causal_mask`), a float32 softmax, times V; `dense`, then the residual
  added; `post_attention_layernorm`; `dense_h_to_4h`, BLOOM's own GELU
  (models/activations.py's `bloom_gelu`), `dense_4h_to_h`, the residual.
  Under `apply_residual_connection_post_layernorm` each residual is the
  layer norm's output, not its input;
- `ln_f`.

The biases count from each text's first real token, so a text's vector
does not depend on how far its batch pads it, on either side; only a
pad's own state does (a query that sees no real key has every score at
float32's lowest and averages every value of its row), which `forceCls`
under left padding pools (models/hf_encoder.py cuts such a call's chunks
from one padded batch).

Refused by name: token types (a tokenizer whose `model_input_names` give
them, which `BloomModel.forward` raises on), `pretraining_tp` above 1
with `slow_but_exact` (transformers then sums sliced products, the
attention's without its bias; the port's choice: no published embedder
sets it), hidden width not a multiple of the heads (transformers
raises).

Parameter names are transformers' `BloomModel`'s
(`word_embeddings.weight`, `word_embeddings_layernorm`,
`h.{i}.input_layernorm`, `h.{i}.self_attention.query_key_value`,
`h.{i}.self_attention.dense`, `h.{i}.post_attention_layernorm`,
`h.{i}.mlp.dense_h_to_4h`, `h.{i}.mlp.dense_4h_to_h`, `ln_f`);
models/checkpoint.py drops `BloomForCausalLM`'s `transformer.` prefix and
its `lm_head.`.

Everything runs in float32. On a CUDA device the forward raises when
`torch.backends.cuda.matmul.allow_tf32` is set, as models/bert.py does.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .activations import bloom_gelu
from .gpt_neo import causal_mask, no_tf32, read

MODEL_TYPE = "bloom"
# BloomConfig's defaults, under its own names
DEFAULTS = {"vocab_size": 250880, "hidden_size": 64, "n_layer": 2, "n_head": 8,
            "layer_norm_epsilon": 1e-5, "apply_residual_connection_post_layernorm": False,
            "pretraining_tp": 1, "slow_but_exact": False}


def check_config(config: dict) -> dict:
    """Raise ValueError unless `config` describes a BLOOM this module runs;
    return it with BloomConfig's defaults filled in and the port's names
    for the widths (`hidden_size`, `n_embed` winning as BloomConfig reads
    it; `num_hidden_layers`, `num_attention_heads`; `intermediate_size`, 4
    x hidden)."""
    kind = config.get("model_type")
    if kind != MODEL_TYPE:
        raise ValueError(f"model_type `{kind}` is not {MODEL_TYPE}")
    config = {**DEFAULTS, **config}
    h = config.get("n_embed") or config["hidden_size"]
    layers = read(config, "n_layer", "num_hidden_layers", DEFAULTS["n_layer"])
    heads = read(config, "n_head", "num_attention_heads", DEFAULTS["n_head"])
    if h % heads:
        raise ValueError("hidden_size is not a multiple of n_head: BloomAttention raises")
    if config["pretraining_tp"] > 1 and config["slow_but_exact"]:
        raise ValueError("slow_but_exact with pretraining_tp > 1 is not supported: transformers"
                         " then sums sliced products (dropping the attention's dense bias); the"
                         " port runs whole ones")
    return {**config, "hidden_size": h, "num_hidden_layers": layers, "num_attention_heads": heads,
            "intermediate_size": 4 * h}


def alibi_slopes(heads: int, device: torch.device) -> torch.Tensor:
    """(heads,) float32: `build_alibi_tensor`'s slopes, op for op."""
    n = 2 ** math.floor(math.log2(heads))
    base = torch.tensor(2 ** (-(2 ** -(math.log2(n) - 3))), device=device, dtype=torch.float32)
    powers = torch.arange(1, 1 + n, device=device, dtype=torch.int32)
    slopes = torch.pow(base, powers)
    if n != heads:
        extra = torch.tensor(2 ** (-(2 ** -(math.log2(2 * n) - 3))), device=device,
                             dtype=torch.float32)
        rest = min(n, heads - n)
        odd = torch.arange(1, 1 + 2 * rest, 2, device=device, dtype=torch.int32)
        slopes = torch.cat([slopes, torch.pow(extra, odd)], dim=0)
    return slopes


def alibi(attention_mask: torch.Tensor, heads: int) -> torch.Tensor:
    """(B * heads, 1, L) float32: each key's bias, its slope times its
    index from its text's first real token (0 on pads)."""
    B, L = attention_mask.shape
    index = ((attention_mask.cumsum(dim=-1) - 1) * attention_mask)[:, None, :]
    out = alibi_slopes(heads, attention_mask.device)[..., None] * index
    return out.reshape(B * heads, 1, L).to(torch.float32)


class _SelfAttention(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        h = c["hidden_size"]
        self.heads = c["num_attention_heads"]
        self.query_key_value = nn.Linear(h, 3 * h)
        self.dense = nn.Linear(h, h)

    def forward(self, x: torch.Tensor, residual: torch.Tensor, bias: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
        B, L, h = x.shape
        heads, d = self.heads, h // self.heads
        fused = self.query_key_value(x).view(B, L, heads, 3, d)  # per head: q, k, v
        q, k, v = (fused[..., i, :].transpose(1, 2) for i in range(3))
        q = q.reshape(B * heads, L, d)
        k = k.reshape(B * heads, L, d).transpose(-1, -2)
        v = v.reshape(B * heads, L, d)
        scores = bias.baddbmm(batch1=q, batch2=k, beta=1.0, alpha=1.0 / math.sqrt(d))
        probs = F.softmax(scores.view(B, heads, L, L) + mask, dim=-1, dtype=torch.float32)
        out = torch.bmm(probs.view(B * heads, L, L), v)
        out = out.view(B, heads, L, d).permute(0, 2, 1, 3).reshape(B, L, h)
        return residual + self.dense(out)


class _MLP(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        h = c["hidden_size"]
        self.dense_h_to_4h = nn.Linear(h, 4 * h)
        self.dense_4h_to_h = nn.Linear(4 * h, h)

    def forward(self, x: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
        return residual + self.dense_4h_to_h(bloom_gelu(self.dense_h_to_4h(x)))


class _Block(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        h, eps = c["hidden_size"], c["layer_norm_epsilon"]
        self.input_layernorm = nn.LayerNorm(h, eps=eps)
        self.self_attention = _SelfAttention(c)
        self.post_attention_layernorm = nn.LayerNorm(h, eps=eps)
        self.mlp = _MLP(c)
        self.post_norm_residual = c["apply_residual_connection_post_layernorm"]

    def forward(self, x: torch.Tensor, bias: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        normed = self.input_layernorm(x)
        a = self.self_attention(normed, normed if self.post_norm_residual else x, bias, mask)
        normed = self.post_attention_layernorm(a)
        return self.mlp(normed, normed if self.post_norm_residual else a)


class BloomModel(nn.Module):
    """A BLOOM stack, widths from a transformers-style config dict
    (`config` holds BloomConfig's names, defaults filled in, and
    `check_config`'s)."""

    # handed the token types a tokenizer gives, to refuse them
    reads_token_types = True

    def __init__(self, config: dict):
        super().__init__()
        config = check_config(config)
        self.config = config
        h, eps = config["hidden_size"], config["layer_norm_epsilon"]
        self.word_embeddings = nn.Embedding(config["vocab_size"], h)
        self.word_embeddings_layernorm = nn.LayerNorm(h, eps=eps)
        self.h = nn.ModuleList(_Block(config) for _ in range(config["num_hidden_layers"]))
        self.ln_f = nn.LayerNorm(h, eps=eps)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, L) int64 ids and 0/1 mask -> (B, L, hidden) float32, the
        last hidden state; token types are refused, as BloomModel.forward
        raises on them."""
        if token_type_ids is not None:
            raise ValueError("token_type_ids are not supported by bloom: BloomModel.forward raises"
                             " on them (the tokenizer's model_input_names must leave them out, as"
                             " BloomTokenizerFast's do)")
        no_tf32(input_ids)
        x = self.word_embeddings_layernorm(self.word_embeddings(input_ids))
        bias = alibi(attention_mask, self.config["num_attention_heads"])
        mask = causal_mask(attention_mask)
        for block in self.h:
            x = block(x, bias, mask)
        return self.ln_f(x)
