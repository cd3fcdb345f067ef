"""XLM's encoder forward as a torch module (the port's K8 for `model_type`
`xlm`: FacebookAI/xlm-mlm-en-2048 and the other XLM checkpoints; and
`flaubert`: flaubert/flaubert_base_cased and the other FlauBERTs).

It computes what transformers' torch `XLMModel` and `FlaubertModel`
compute, the models the JAX package's encoder (`models/hf_encoder.py`
there) runs through its torch branch, since transformers has no Flax XLM
or FlauBERT. It returns the last hidden state (pooling stays in
models/hf_encoder.py):

- embeddings: word (`embeddings`) + position (`position_embeddings`,
  0..L-1: the file's table, learned or, with `sinusoidal_embeddings`, the
  sinusoid transformers wrote into it, read as transformers loads it);
  then, when the tokenizer passes `token_type_ids`, those ids looked up in
  the WORD table and added (XLM's own layout: a single text's zeros add
  word row 0 to every token; a tokenizer class that passes none, such as
  XLM-RoBERTa's, adds nothing); `layer_norm_emb`; then times the padding
  mask, so padded rows are zeros. The language embedding is added only
  when `langs` is passed, which the reference's encoder never does: it is
  held (with `n_langs` > 1 and `use_lang_emb`) and never read;
- each layer, post-norm: Q / sqrt(d_head) times K^T, masked keys REPLACED
  by finfo(float32).min, softmax, times V, `out_lin`; `layer_norm1(x +
  attention)`; `layer_norm2(x + lin2(act(lin1(x))))` with `lin1` 4 x
  `emb_dim` wide and exact GELU (`gelu_activation`, else ReLU); times the
  padding mask. Without `causal` the masked keys are the padding; with it,
  the keys after the query (and padding is not masked: transformers builds
  the causal mask alone);
- FlauBERT is XLM's forward (`FlaubertConfig` is `XLMConfig`'s defaults
  and two more), but with `pre_norm` each layer is `x + attention(
  layer_norm1(x))`, then `x + ffn(layer_norm2(x))`, times the padding
  mask, and no norm after either and none at the end
  (`modeling_flaubert.py:944-974`); `layerdrop` is read and ignored (it
  drops layers only in training). An `xlm` config's `pre_norm` is not
  read, as XLMModel reads none.

Config names follow `XLMConfig`, its `attribute_map` included:
`hidden_size`, `num_attention_heads`, `num_hidden_layers` and `n_words`
stand for `emb_dim`, `n_heads`, `n_layers` and `vocab_size`, and win
where a file gives both, as `PretrainedConfig` sets them last. Refused by
name: `is_encoder: false` (transformers raises) and an `emb_dim` that is
not a multiple of `n_heads`.

Attention is written as explicit products and a softmax, not
`scaled_dot_product_attention`. Parameter names are `XLMModel`'s
(`position_embeddings.weight`, `embeddings.weight`, `layer_norm_emb.weight`,
`attentions.{i}.q_lin.weight`, `layer_norm1.{i}.weight`,
`ffns.{i}.lin1.weight`, `layer_norm2.{i}.weight`, ...), so a checkpoint's
tensors load by name (models/checkpoint.py drops the `transformer.`
prefix).

Everything runs in float32. On a CUDA device the forward raises when
`torch.backends.cuda.matmul.allow_tf32` is set, as models/bert.py does.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

MODEL_TYPE, FLAUBERT_TYPE = "xlm", "flaubert"
# XLMConfig's defaults, xlm-mlm-en-2048's widths
DEFAULTS = {"vocab_size": 30145, "emb_dim": 2048, "n_layers": 12, "n_heads": 16,
            "gelu_activation": True, "sinusoidal_embeddings": False, "causal": False,
            "n_langs": 1, "use_lang_emb": True, "max_position_embeddings": 512,
            "layer_norm_eps": 1e-12, "pad_index": 2, "is_encoder": True}
# FlaubertConfig's: XLMConfig's and its own two
FLAUBERT_DEFAULTS = {**DEFAULTS, "pre_norm": False, "layerdrop": 0.0}
# XLMConfig.attribute_map (FlaubertConfig's too): the name a file may use -> XLM's own
ALIASES = {"hidden_size": "emb_dim", "num_attention_heads": "n_heads",
           "num_hidden_layers": "n_layers", "n_words": "vocab_size"}


def check_config(config: dict) -> dict:
    """Raise ValueError unless `config` describes an XLM or FlauBERT this
    module runs; return it with XLMConfig's (FlaubertConfig's) defaults, its
    aliases resolved, `pre_norm` as the model reads it, and BERT's width
    names (`hidden_size`, `num_hidden_layers`, `num_attention_heads`,
    `intermediate_size` = 4 x `emb_dim`) for models/hf_encoder.py."""
    flaubert = config.get("model_type") == FLAUBERT_TYPE
    config = {**(FLAUBERT_DEFAULTS if flaubert else DEFAULTS), **config}
    for alias, name in ALIASES.items():
        if alias in config:
            config[name] = config[alias]
    if not config["is_encoder"]:
        raise ValueError("is_encoder: false is not supported: transformers' XLMModel raises"
                         " (XLM runs as an encoder only)")
    if config["emb_dim"] % config["n_heads"]:
        raise ValueError("emb_dim is not a multiple of n_heads")
    return {**config, "pre_norm": flaubert and bool(config["pre_norm"]),
            "hidden_size": config["emb_dim"], "num_attention_heads": config["n_heads"],
            "num_hidden_layers": config["n_layers"], "intermediate_size": 4 * config["emb_dim"]}


class _Attention(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        h = c["emb_dim"]
        self.heads = c["n_heads"]
        self.q_lin = nn.Linear(h, h)
        self.k_lin = nn.Linear(h, h)
        self.v_lin = nn.Linear(h, h)
        self.out_lin = nn.Linear(h, h)

    def forward(self, x: torch.Tensor, blocked: torch.Tensor) -> torch.Tensor:
        B, L, h = x.shape
        d = h // self.heads

        def split(t):  # (B, L, h) -> (B, heads, L, d)
            return t.view(B, L, self.heads, d).transpose(1, 2)

        q = split(self.q_lin(x)) / math.sqrt(d)
        scores = torch.matmul(q, split(self.k_lin(x)).transpose(2, 3))
        scores.masked_fill_(blocked, torch.finfo(scores.dtype).min)
        probs = torch.softmax(scores, dim=-1)
        ctx = torch.matmul(probs, split(self.v_lin(x))).transpose(1, 2).reshape(B, L, h)
        return self.out_lin(ctx)


class _FFN(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        self.lin1 = nn.Linear(c["emb_dim"], 4 * c["emb_dim"])
        self.lin2 = nn.Linear(4 * c["emb_dim"], c["emb_dim"])
        self.act = F.gelu if c["gelu_activation"] else F.relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.lin2(self.act(self.lin1(x)))


class XLMModel(nn.Module):
    """XLM's (or FlauBERT's) encoder, widths from a transformers-style
    config dict (XLMConfig's names, defaults filled in)."""

    reads_token_types = True  # looked up in the word table

    def __init__(self, config: dict):
        super().__init__()
        c = check_config(config)
        self.config = c
        h = c["emb_dim"]
        self.position_embeddings = nn.Embedding(c["max_position_embeddings"], h)
        if c["n_langs"] > 1 and c["use_lang_emb"]:
            self.lang_embeddings = nn.Embedding(c["n_langs"], h)
        self.embeddings = nn.Embedding(c["vocab_size"], h)
        self.layer_norm_emb = nn.LayerNorm(h, eps=c["layer_norm_eps"])
        n = c["n_layers"]
        self.attentions = nn.ModuleList(_Attention(c) for _ in range(n))
        self.layer_norm1 = nn.ModuleList(nn.LayerNorm(h, eps=c["layer_norm_eps"])
                                         for _ in range(n))
        self.ffns = nn.ModuleList(_FFN(c) for _ in range(n))
        self.layer_norm2 = nn.ModuleList(nn.LayerNorm(h, eps=c["layer_norm_eps"])
                                         for _ in range(n))

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, L) int64 ids, 0/1 mask and (optionally) token types -> (B, L,
        emb_dim) float32, the last hidden state."""
        if input_ids.is_cuda and torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError(
                "the text encoder needs full float32 matmuls:"
                " torch.backends.cuda.matmul.allow_tf32 is True"
            )
        L = input_ids.shape[1]
        x = self.embeddings(input_ids) + self.position_embeddings.weight[:L]
        if token_type_ids is not None:
            x = x + self.embeddings(token_type_ids)
        keep = attention_mask[:, :, None].to(torch.float32)
        x = self.layer_norm_emb(x) * keep
        if self.config["causal"]:  # keys after the query, padding or not
            pos = torch.arange(L, device=x.device)
            blocked = (pos[None, :] > pos[:, None])[None, None]
        else:
            blocked = (attention_mask == 0)[:, None, None, :]  # (B, 1, 1, L): padded keys
        pre_norm = self.config["pre_norm"]
        for attention, norm1, ffn, norm2 in zip(self.attentions, self.layer_norm1, self.ffns,
                                                self.layer_norm2):
            if pre_norm:
                x = x + attention(norm1(x), blocked)
                x = (x + ffn(norm2(x))) * keep
            else:
                x = norm1(x + attention(x, blocked))
                x = norm2(x + ffn(x)) * keep
        return x
