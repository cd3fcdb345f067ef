"""Longformer's encoder forward as a torch module (the port's K8 for
`model_type` `longformer`: allenai/longformer-base-4096 and its
fine-tunes).

It computes what transformers' torch `LongformerModel` computes when the
JAX package's encoder (`models/hf_encoder.py` there) runs it through its
torch branch (transformers has no Flax Longformer), and returns the last
hidden state. That call passes no `global_attention_mask`, so no token is
global and every query attends only to its local window:

- embeddings: RoBERTa's (models/bert.py's), positions counted from
  `pad_token_id` + 1 over the tokens that are not the pad id;
- each layer: BERT's post-norm layer around a local self-attention. Q is
  divided by sqrt(head_dim) after its bias, before the product with K
  (`LongformerSelfAttention.forward`). Query i sees key j iff |i - j| <=
  attention_window[layer] // 2 and j is a real token: every other score
  is REPLACED by finfo(float32).min (`masked_fill_`; transformers adds it
  to a padded key's score and never computes a score outside the band,
  which gives the same probabilities wherever a query sees a key). After
  the softmax, the probabilities of every padded query are set to exactly
  0, as transformers sets them (its "softmax sometimes inserts NaN" fill
  of `is_index_masked`): a padded query whose band holds only pads sees
  no key, and its output is 0, never NaN (hazard 3.18);
- `attention_window` is an int (every layer) or a list of one even,
  positive window a layer.

The batch runs at its own padded length. transformers first pads the ids
to a multiple of the largest window (`LongformerModel._pad_to_window_size`:
a 14-token query becomes 512 positions under longformer-base-4096's
windows) and cuts those rows from its output. Those pads are masked keys
for every query, so no real row reads them; a real row's band is the same
set of keys at either length (indices count from the batch's start in
both, and the band past the batch's end holds only masked pads); and the
padded queries' rows are zeroed before they reach the next layer. So the
rows the reference returns are the ones this module computes, without
the card running 512 positions for a short query.

The checkpoint's `query_global`, `key_global` and `value_global`
projections are read (they are the module's parameters, so a checkpoint
loads by name) and never used: no token is global. A
`global_attention_mask` is refused: the reference never passes one.

Refused by name, as transformers asserts on each: an odd window, a window
of 0 or less, and a window list whose length is not `num_hidden_layers`.
Parameter names are transformers' `LongformerModel`'s
(models/checkpoint.py drops the `longformer.` prefix and the heads).

Everything runs in float32. On a CUDA device the forward raises when
`torch.backends.cuda.matmul.allow_tf32` is set, as models/bert.py does.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from .activations import activation
from .bert import _Embeddings, _Intermediate, _Output

MODEL_TYPE = "longformer"
# LongformerConfig's defaults for the keys a config may leave out
DEFAULTS = {"attention_window": 512, "vocab_size": 30522, "hidden_size": 768,
            "num_hidden_layers": 12, "num_attention_heads": 12, "intermediate_size": 3072,
            "hidden_act": "gelu", "max_position_embeddings": 512, "type_vocab_size": 2,
            "layer_norm_eps": 1e-12, "pad_token_id": 1}


def check_config(config: dict) -> dict:
    """Raise ValueError unless `config` describes a Longformer this module
    runs; return it with LongformerConfig's defaults filled in,
    `attention_window` a list of one window a layer, and `embedding_size`
    (the embeddings' width, `hidden_size`)."""
    kind = config.get("model_type")
    if kind != MODEL_TYPE:
        raise ValueError(f"model_type `{kind}` is not {MODEL_TYPE}")
    config = {**DEFAULTS, **config}
    activation(config["hidden_act"])
    if config["hidden_size"] % config["num_attention_heads"]:
        raise ValueError("hidden_size is not a multiple of num_attention_heads")
    windows = config["attention_window"]
    layers = config["num_hidden_layers"]
    if isinstance(windows, int):
        windows = [windows] * layers
    elif len(windows) != layers:
        raise ValueError(f"attention_window has {len(windows)} entries, not one for each of"
                         f" the {layers} layers (transformers asserts that"
                         " `len(config.attention_window)` equals num_hidden_layers)")
    for i, w in enumerate(windows):
        if w % 2:
            raise ValueError(f"attention_window {w} of layer {i} is odd: transformers asserts"
                             " that each window is an even value")
        if w <= 0:
            raise ValueError(f"attention_window {w} of layer {i} is not positive: transformers"
                             " asserts that each window is positive")
    return {**config, "attention_window": list(windows), "embedding_size": config["hidden_size"]}


def band_blocked(L: int, window: int, pad_keys: torch.Tensor) -> torch.Tensor:
    """(B, 1, L, L) bool: key j is blocked for query i iff |i - j| >
    window // 2 or j is a padded key (`pad_keys`, (B, 1, 1, L))."""
    pos = torch.arange(L, device=pad_keys.device)
    outside = (pos[:, None] - pos[None, :]).abs() > window // 2
    return outside[None, None] | pad_keys


class _LocalSelfAttention(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        h = c["hidden_size"]
        self.heads = c["num_attention_heads"]
        self.query = nn.Linear(h, h)
        self.key = nn.Linear(h, h)
        self.value = nn.Linear(h, h)
        # the global projections: loaded, never read (no token is global)
        self.query_global = nn.Linear(h, h)
        self.key_global = nn.Linear(h, h)
        self.value_global = nn.Linear(h, h)

    def forward(self, x: torch.Tensor, blocked: torch.Tensor,
                pad_queries: torch.Tensor) -> torch.Tensor:
        B, L, h = x.shape
        d = h // self.heads

        def split(t):  # (B, L, h) -> (B, heads, L, d)
            return t.view(B, L, self.heads, d).transpose(1, 2)

        q = split(self.query(x) / math.sqrt(d))  # scaled after its bias
        scores = torch.matmul(q, split(self.key(x)).transpose(-1, -2))
        scores.masked_fill_(blocked, torch.finfo(scores.dtype).min)
        probs = torch.softmax(scores, dim=-1).masked_fill_(pad_queries, 0.0)
        return torch.matmul(probs, split(self.value(x))).transpose(1, 2).reshape(B, L, h)


class _Attention(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        self.self = _LocalSelfAttention(c)
        self.output = _Output(c["hidden_size"], c)


class _Layer(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        self.attention = _Attention(c)
        self.intermediate = _Intermediate(c)
        self.output = _Output(c["intermediate_size"], c)

    def forward(self, x: torch.Tensor, blocked: torch.Tensor,
                pad_queries: torch.Tensor) -> torch.Tensor:
        a = self.attention.output(self.attention.self(x, blocked, pad_queries), x)
        return self.output(self.intermediate(a), a)


class _Encoder(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        self.layer = nn.ModuleList(_Layer(c) for _ in range(c["num_hidden_layers"]))


class LongformerModel(nn.Module):
    """A Longformer stack of local attention only, widths from a
    transformers-style config dict (`config` holds LongformerConfig's
    names, defaults filled in, `attention_window` one window a layer)."""

    def __init__(self, config: dict):
        super().__init__()
        config = check_config(config)
        self.config = config
        self.embeddings = _Embeddings(config)
        self.encoder = _Encoder(config)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                global_attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, L) int64 ids and 0/1 mask -> (B, L, hidden) float32, the
        last hidden state."""
        if global_attention_mask is not None:
            raise ValueError("a global_attention_mask is not supported: the reference encoder"
                             " passes none, so no token is global")
        if input_ids.is_cuda and torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError(
                "the text encoder needs full float32 matmuls:"
                " torch.backends.cuda.matmul.allow_tf32 is True"
            )
        L = input_ids.shape[1]
        x = self.embeddings(input_ids)
        pad = attention_mask == 0
        pad_keys, pad_queries = pad[:, None, None, :], pad[:, None, :, None]
        blocked = {w: band_blocked(L, w, pad_keys) for w in set(self.config["attention_window"])}
        for layer, w in zip(self.encoder.layer, self.config["attention_window"]):
            x = layer(x, blocked[w], pad_queries)
        return x
