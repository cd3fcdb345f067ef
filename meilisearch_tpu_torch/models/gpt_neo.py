"""GPT-Neo's forward as one torch module (the port's K8 for `model_type`
`gpt_neo`: EleutherAI's GPT-Neo and the SGPT embedders built on it,
Muennighoff/SGPT-125M-weightedmean-nli-bitfit, -1.3B and -2.7B).

It computes what transformers' torch `GPTNeoModel` computes under its
only attention for an embedding call (`eager`: the class has no `sdpa`)
on a padded batch, the model the JAX package's encoder
(`models/hf_encoder.py` there) runs through its torch branch, and returns
the last hidden state (pooling stays in models/hf_encoder.py):

- `wte` plus `wpe` at positions 0..L-1 in every row (`position_ids` is
  `cache_position`, counted from the padded start, not from the mask: a
  left-padded text's positions shift with its batch's padded length);
- each layer, pre-norm: `ln_1`, then Q, K and V without bias, each head's
  scores Q K^T in float32 with NO 1/sqrt(head_dim) scale, the causal bias
  (`tril`) and, on a `local` layer, `tril XOR tril(., -window_size)`: a
  query sees itself and the window_size - 1 keys before it. Scores outside
  the bias are REPLACED by float32's lowest (`torch.where`), then the
  additive mask (`causal_mask`: lowest where a key is later or padded, 0
  elsewhere) is added on top, then the softmax and the product with V,
  `out_proj` (with bias), the residual; `ln_2`, `c_fc`, the activation
  (`activation_function`, `gelu_new` by default), `c_proj`, the residual;
- `ln_f`.

The two masks are applied in the reference's order and with its values,
so a query that sees no real key (a left pad) attends as there: where the
bias lets it see keys, each of their scores becomes lowest + lowest's
neighbour (lowest) and the rest -inf, so it averages the values of the
keys the bias lets it see (under left padding the pad at position 0
sees only itself); `forceCls` pools that state.

`attention_types` (`[[["global", "local"], n], ...]`) expands to one type
a layer, and a config.json's `attention_layers`, when present, is the
list read, as `PretrainedConfig` sets it after the expansion. Refused by
name, as transformers raises on each: an expansion whose length is not
`num_layers`, an entry other than `global` and `local`, hidden_size not a
multiple of the heads, an activation models/activations.py does not run,
and a batch longer than `max_position_embeddings` (`wpe` and the bias have
no row for it).

Parameter names are transformers' `GPTNeoModel`'s (`wte.weight`,
`wpe.weight`, `h.{i}.ln_1.{weight,bias}`,
`h.{i}.attn.attention.{q,k,v}_proj.weight`,
`h.{i}.attn.attention.out_proj.{weight,bias}`, `h.{i}.ln_2`,
`h.{i}.mlp.c_fc`, `h.{i}.mlp.c_proj`, `ln_f`); models/checkpoint.py drops
`GPTNeoForCausalLM`'s `transformer.` prefix, its `lm_head.` and the stale
`attn.attention.bias` / `masked_bias` buffers older files hold.

Token types, where the tokenizer gives them (a class whose
`model_input_names` name them: GPT-2's and BLOOM's do not), add their rows
of `wte`, as `GPTNeoModel.forward` adds them.

`causal_mask`, `read` and `no_tf32` serve models/gptj.py and
models/bloom.py too.

Everything runs in float32. On a CUDA device the forward raises when
`torch.backends.cuda.matmul.allow_tf32` is set, as models/bert.py does.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .activations import activation

MODEL_TYPE = "gpt_neo"
ATTENTION_TYPES = ("global", "local")
# GPTNeoConfig's defaults, under its own names
DEFAULTS = {"vocab_size": 50257, "max_position_embeddings": 2048, "hidden_size": 2048,
            "num_layers": 24, "attention_types": [[["global", "local"], 12]], "num_heads": 16,
            "intermediate_size": None, "window_size": 256, "activation_function": "gelu_new",
            "layer_norm_epsilon": 1e-5}


def read(config: dict, own: str, alias: str, default):
    """A config value as a transformers config class holds it: its
    `attribute_map` alias (`num_attention_heads` for GPT-Neo's
    `num_heads`), when config.json gives one, wins over the class's own
    name, since `PretrainedConfig` sets the leftover keyword after the
    class has set its own argument."""
    if alias in config:
        return config[alias]
    return config.get(own, default)


def no_tf32(input_ids: torch.Tensor) -> None:
    if input_ids.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "the text encoder needs full float32 matmuls:"
            " torch.backends.cuda.matmul.allow_tf32 is True"
        )


def causal_mask(attention_mask: torch.Tensor) -> torch.Tensor:
    """(B, 1, L, L) float32: 0 where key j is visible to query i (j <= i
    and j a real token), float32's lowest elsewhere; the additive mask
    transformers' GPT-Neo, GPT-J and BLOOM build with
    `_prepare_4d_causal_attention_mask_with_cache_position` (no cache: the
    target length is L, `cache_position` 0..L-1), op for op."""
    B, L = attention_mask.shape
    device = attention_mask.device
    lowest = torch.finfo(torch.float32).min
    mask = torch.triu(torch.full((L, L), lowest, dtype=torch.float32, device=device), diagonal=1)
    rows = torch.arange(L, device=device)
    mask *= torch.arange(L, device=device) > rows.reshape(-1, 1)
    mask = mask[None, None, :, :].expand(B, 1, -1, -1).clone()
    padding = (mask + attention_mask[:, None, None, :]) == 0
    return mask.masked_fill(padding, lowest)


def check_config(config: dict) -> dict:
    """Raise ValueError unless `config` describes a GPT-Neo this module
    runs; return it with GPTNeoConfig's defaults filled in and the
    port's names added: `num_hidden_layers`, `num_attention_heads`,
    `intermediate_size` (4 x hidden_size when null), `layer_types` (one of
    ATTENTION_TYPES a layer) and `window`."""
    kind = config.get("model_type")
    if kind != MODEL_TYPE:
        raise ValueError(f"model_type `{kind}` is not {MODEL_TYPE}")
    config = {**DEFAULTS, **config}
    layers = read(config, "num_layers", "num_hidden_layers", DEFAULTS["num_layers"])
    heads = read(config, "num_heads", "num_attention_heads", DEFAULTS["num_heads"])
    expanded = [t for types, n in config["attention_types"] for _ in range(n) for t in types]
    if len(expanded) != config["num_layers"]:
        raise ValueError(f"attention_types {config['attention_types']} expand to {len(expanded)}"
                         f" layer types, not num_layers {config['num_layers']}: GPTNeoConfig"
                         " raises")
    types = list(config.get("attention_layers") or expanded)
    unknown = sorted({t for t in types if t not in ATTENTION_TYPES})
    if unknown:
        raise ValueError(f"attention_types entries {unknown} are not supported: GPT-Neo runs only"
                         f" {ATTENTION_TYPES}, and transformers raises NotImplementedError")
    if len(types) != layers:
        raise ValueError(f"{len(types)} attention layer types for {layers} layers: transformers"
                         " indexes a missing type")
    if config["hidden_size"] % heads:
        raise ValueError("hidden_size is not a multiple of num_heads: GPTNeoSelfAttention raises")
    activation(config["activation_function"], "activation_function")
    return {**config, "num_hidden_layers": layers, "num_attention_heads": heads,
            "intermediate_size": config["intermediate_size"] or 4 * config["hidden_size"],
            "layer_types": types, "window": config["window_size"]}


class _SelfAttention(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        h = c["hidden_size"]
        self.heads = c["num_attention_heads"]
        self.k_proj = nn.Linear(h, h, bias=False)
        self.v_proj = nn.Linear(h, h, bias=False)
        self.q_proj = nn.Linear(h, h, bias=False)
        self.out_proj = nn.Linear(h, h)

    def forward(self, x: torch.Tensor, seen: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        B, L, h = x.shape
        d = h // self.heads

        def split(t):  # (B, L, h) -> (B, heads, L, d)
            return t.view(B, L, self.heads, d).permute(0, 2, 1, 3)

        q, k, v = split(self.q_proj(x)), split(self.k_proj(x)), split(self.v_proj(x))
        scores = torch.matmul(q, k.transpose(-1, -2))  # no 1/sqrt(d)
        lowest = torch.tensor(torch.finfo(scores.dtype).min, dtype=scores.dtype,
                              device=scores.device)
        scores = torch.where(seen, scores, lowest) + mask
        probs = torch.softmax(scores, dim=-1)
        out = torch.matmul(probs, v).permute(0, 2, 1, 3).contiguous().view(B, L, h)
        return self.out_proj(out)


class _Attention(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        self.attention = _SelfAttention(c)


class _MLP(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        self.c_fc = nn.Linear(c["hidden_size"], c["intermediate_size"])
        self.c_proj = nn.Linear(c["intermediate_size"], c["hidden_size"])
        self.act = activation(c["activation_function"], "activation_function")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.c_proj(self.act(self.c_fc(x)))


class _Block(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        h, eps = c["hidden_size"], c["layer_norm_epsilon"]
        self.ln_1 = nn.LayerNorm(h, eps=eps)
        self.attn = _Attention(c)
        self.ln_2 = nn.LayerNorm(h, eps=eps)
        self.mlp = _MLP(c)

    def forward(self, x: torch.Tensor, seen: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = self.attn.attention(self.ln_1(x), seen, mask) + x
        return x + self.mlp(self.ln_2(x))


class GPTNeoModel(nn.Module):
    """A GPT-Neo stack, widths from a transformers-style config dict
    (`config` holds GPTNeoConfig's names, defaults filled in, and
    `check_config`'s)."""

    # the reference passes a tokenizer's token types, and GPTNeoModel adds
    # their rows of `wte` (a class that gives none leaves them out)
    reads_token_types = True

    def __init__(self, config: dict):
        super().__init__()
        config = check_config(config)
        self.config = config
        h = config["hidden_size"]
        self.wte = nn.Embedding(config["vocab_size"], h)
        self.wpe = nn.Embedding(config["max_position_embeddings"], h)
        self.h = nn.ModuleList(_Block(config) for _ in range(config["num_hidden_layers"]))
        self.ln_f = nn.LayerNorm(h, eps=config["layer_norm_epsilon"])

    def seen(self, L: int, device: torch.device) -> dict:
        """Each attention type's (L, L) bool bias: True where query i may
        see key j (`tril`; on `local` XORed with `tril(., -window)`)."""
        causal = torch.tril(torch.ones((L, L), dtype=torch.bool, device=device))
        return {"global": causal,
                "local": torch.bitwise_xor(causal, torch.tril(causal, -self.config["window"]))}

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, L) int64 ids and 0/1 mask (and token types, where the
        tokenizer gives them) -> (B, L, hidden) float32, the last hidden
        state."""
        no_tf32(input_ids)
        L = input_ids.shape[1]
        if L > self.config["max_position_embeddings"]:
            raise ValueError(f"a batch of {L} tokens passes max_position_embeddings"
                             f" {self.config['max_position_embeddings']}: GPT-Neo has no"
                             " position for it")
        positions = torch.arange(L, device=input_ids.device)[None]
        x = self.wte(input_ids) + self.wpe(positions)
        if token_type_ids is not None:
            x = x + self.wte(token_type_ids)
        seen, mask = self.seen(L, input_ids.device), causal_mask(attention_mask)
        for block, kind in zip(self.h, self.config["layer_types"]):
            x = block(x, seen[kind], mask)
        return self.ln_f(x)
