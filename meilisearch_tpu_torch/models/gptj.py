"""GPT-J's forward as one torch module (the port's K8 for `model_type`
`gptj`: EleutherAI's GPT-J-6B and the SGPT embedder built on it,
Muennighoff/SGPT-5.8B-weightedmean-msmarco-specb-bitfit).

It computes what transformers' torch `GPTJModel` computes under its only
attention for an embedding call (`eager`) on a padded batch, the model
the JAX package's encoder (`models/hf_encoder.py` there) runs through its
torch branch, and returns the last hidden state:

- `wte`; no position embedding;
- each layer: one `ln_1`, then attention and MLP side by side on its
  output, `attn(h) + mlp(h) + residual` in that order. Q, K, V and
  `out_proj` have no bias. The first `rotary_dim` channels of each head
  of Q and K are rotated at positions 0..L-1 in every row (counted from
  the padded start, as `position_ids = cache_position`): the sinusoid
  table `create_sinusoidal_positions` builds (float32 `inv_freq` from an
  int64 `arange / dim`, its sin and cos halves), each entry repeated
  twice (`repeat_interleave`) and applied with `rotate_every_two`, the
  interleaved pairs (models/roformer.py's `rotate`, the same ops); the
  rest of the head passes through. Scores Q K^T in float32 divided by
  `sqrt(head_dim)` (a float32 tensor, `scale_attn`), plus the additive
  causal and padding mask (models/gpt_neo.py's `causal_mask`), softmax,
  times V; the MLP is `fc_in`, the activation (`gelu_new`), `fc_out`;
- `ln_f`.

Token types, where the tokenizer gives them, add their rows of `wte`, as
`GPTJModel.forward` adds them.

The rotary tables are built on the host, cached by length, and copied to
the device: transformers builds them on the CPU at load time. A query
that sees no real key (a left pad) has every score at float32's lowest,
so it averages every value of its row, as the reference's does.

Refused by name, as transformers raises on each: an odd `rotary_dim`
(`rotate_every_two` cannot stack its halves), one wider than the head
(a null `rotary_dim` rotates `n_embd` channels, wider than the head
unless there is one head), hidden width not a multiple of the heads, an
activation models/activations.py does not run, and a batch longer than
`n_positions` (the table has no row for it).

Parameter names are transformers' `GPTJModel`'s (`wte.weight`,
`h.{i}.ln_1.{weight,bias}`, `h.{i}.attn.{q,k,v,out}_proj.weight`,
`h.{i}.mlp.fc_in`, `h.{i}.mlp.fc_out`, `ln_f`); models/checkpoint.py
drops `GPTJForCausalLM`'s `transformer.` prefix, its `lm_head.` and the
stale `attn.bias` / `attn.masked_bias` buffers.

Everything runs in float32. On a CUDA device the forward raises when
`torch.backends.cuda.matmul.allow_tf32` is set, as models/bert.py does.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional

import torch
from torch import nn

from .activations import activation
from .gpt_neo import causal_mask, no_tf32, read
from .roformer import rotate

MODEL_TYPE = "gptj"
# GPTJConfig's defaults, under its own names
DEFAULTS = {"vocab_size": 50400, "n_positions": 2048, "n_embd": 4096, "n_layer": 28,
            "n_head": 16, "rotary_dim": 64, "n_inner": None, "activation_function": "gelu_new",
            "layer_norm_epsilon": 1e-5}
# GPTJConfig's attribute_map: the port's names -> GPT-J's
ALIASES = {"hidden_size": "n_embd", "num_hidden_layers": "n_layer",
           "num_attention_heads": "n_head", "max_position_embeddings": "n_positions"}


def check_config(config: dict) -> dict:
    """Raise ValueError unless `config` describes a GPT-J this module runs;
    return it with GPTJConfig's defaults filled in, the port's names for
    the widths (`hidden_size`, `num_hidden_layers`, `num_attention_heads`,
    `max_position_embeddings`, `intermediate_size`) and `rotary_dim`
    resolved."""
    kind = config.get("model_type")
    if kind != MODEL_TYPE:
        raise ValueError(f"model_type `{kind}` is not {MODEL_TYPE}")
    config = {**DEFAULTS, **config}
    widths = {ours: read(config, theirs, ours, DEFAULTS[theirs])
              for ours, theirs in ALIASES.items()}
    h, heads = widths["hidden_size"], widths["num_attention_heads"]
    if h % heads:
        raise ValueError("n_embd is not a multiple of n_head: GPTJAttention raises")
    rotary = config["rotary_dim"] or h
    if rotary % 2 or rotary > h // heads:
        raise ValueError(f"rotary_dim {config['rotary_dim']} is not supported for heads of"
                         f" {h // heads}: transformers' rotary raises on an odd one or one"
                         " wider than the head")
    activation(config["activation_function"], "activation_function")
    return {**config, **widths, "rotary_dim": rotary,
            "intermediate_size": config["n_inner"] or 4 * h}


@lru_cache(maxsize=16)
def sincos(L: int, dim: int) -> tuple:
    """(sin, cos), each (1, L, 1, dim) float32 on the host: GPT-J's
    sinusoid table over `dim` rotated channels at positions 0..L-1,
    each entry repeated twice."""
    inv_freq = 1.0 / (10000 ** (torch.arange(0, dim, 2, dtype=torch.int64) / dim))
    angles = torch.einsum("i , j -> i j", torch.arange(L, dtype=torch.int64).float(),
                          inv_freq).float()
    sin, cos = torch.sin(angles)[None], torch.cos(angles)[None]
    return (torch.repeat_interleave(sin[:, :, None, :], 2, 3),
            torch.repeat_interleave(cos[:, :, None, :], 2, 3))


class _Attention(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        h = c["hidden_size"]
        self.heads, self.rotary = c["num_attention_heads"], c["rotary_dim"]
        self.k_proj = nn.Linear(h, h, bias=False)
        self.v_proj = nn.Linear(h, h, bias=False)
        self.q_proj = nn.Linear(h, h, bias=False)
        self.out_proj = nn.Linear(h, h, bias=False)

    def forward(self, x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor,
                mask: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        B, L, h = x.shape
        d, r = h // self.heads, self.rotary
        q = self.q_proj(x).view(B, L, self.heads, d)
        k = self.k_proj(x).view(B, L, self.heads, d)
        v = self.v_proj(x).view(B, L, self.heads, d).permute(0, 2, 1, 3)
        if r == d:
            k, q = rotate(k, sin, cos), rotate(q, sin, cos)
        else:
            k = torch.cat([rotate(k[..., :r], sin, cos), k[..., r:]], dim=-1)
            q = torch.cat([rotate(q[..., :r], sin, cos), q[..., r:]], dim=-1)
        k, q = k.permute(0, 2, 1, 3), q.permute(0, 2, 1, 3)
        scores = torch.matmul(q, k.transpose(-1, -2)) / scale + mask
        probs = torch.softmax(scores, dim=-1)
        out = torch.matmul(probs, v).permute(0, 2, 1, 3).contiguous().view(B, L, h)
        return self.out_proj(out)


class _MLP(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        self.fc_in = nn.Linear(c["hidden_size"], c["intermediate_size"])
        self.fc_out = nn.Linear(c["intermediate_size"], c["hidden_size"])
        self.act = activation(c["activation_function"], "activation_function")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc_out(self.act(self.fc_in(x)))


class _Block(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        self.ln_1 = nn.LayerNorm(c["hidden_size"], eps=c["layer_norm_epsilon"])
        self.attn = _Attention(c)
        self.mlp = _MLP(c)

    def forward(self, x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor,
                mask: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        h = self.ln_1(x)
        return self.attn(h, sin, cos, mask, scale) + self.mlp(h) + x


class GPTJModel(nn.Module):
    """A GPT-J stack, widths from a transformers-style config dict
    (`config` holds GPTJConfig's names, defaults filled in, and
    `check_config`'s)."""

    # as GPTNeoModel: given token types add their rows of `wte`
    reads_token_types = True

    def __init__(self, config: dict):
        super().__init__()
        config = check_config(config)
        self.config = config
        h = config["hidden_size"]
        self.wte = nn.Embedding(config["vocab_size"], h)
        self.h = nn.ModuleList(_Block(config) for _ in range(config["num_hidden_layers"]))
        self.ln_f = nn.LayerNorm(h, eps=config["layer_norm_epsilon"])

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, L) int64 ids and 0/1 mask (and token types, where the
        tokenizer gives them) -> (B, L, hidden) float32, the last hidden
        state."""
        no_tf32(input_ids)
        c = self.config
        L, device = input_ids.shape[1], input_ids.device
        if L > c["max_position_embeddings"]:
            raise ValueError(f"a batch of {L} tokens passes n_positions"
                             f" {c['max_position_embeddings']}: GPT-J's rotary table has no row"
                             " for it")
        sin, cos = (t.to(device) for t in sincos(L, c["rotary_dim"]))
        # scale_attn: sqrt(head_dim) taken in float32
        scale = torch.sqrt(torch.tensor(c["hidden_size"] // c["num_attention_heads"],
                                        dtype=torch.float32)).to(device)
        mask = causal_mask(attention_mask)
        x = self.wte(input_ids)
        if token_type_ids is not None:
            x = x + self.wte(token_type_ids)
        for block in self.h:
            x = block(x, sin, cos, mask, scale)
        return self.ln_f(x)
