"""XLNet's encoder forward as a torch module (the port's K8 for
`model_type` `xlnet`: xlnet-base-cased and the models fine-tuned from it),
the content stream only.

It computes what transformers' torch `XLNetModel` computes for one forward
without memory, target mapping or permutation mask, the call the JAX
package's encoder (`models/hf_encoder.py` there) makes through its torch
branch (transformers has no Flax XLNet). It returns the last hidden state
(pooling stays in models/hf_encoder.py):

- the word embedding alone (no absolute position);
- the relative positional encoding: positions `klen, klen - 1, ...` down
  to (not including) `-qlen` (`attn_type` `bi`), clamped to +-`clamp_len`
  when that is positive, through `sin` and `cos` of inv_freq = 1 /
  10000^(2i / d_model), laid side by side. The table is
  built on the host with transformers' own torch ops at the same shape,
  cached by length, and copied to the device;
- each layer: Q, K, V from `q`, `k`, `v` (d_model, heads, d_head), the
  position keys from `r`; the content score (Q + `r_w_bias`) K^T; the
  position score (Q + `r_r_bias`) R^T, moved into place by
  `rel_shift_bnij` (the same reshapes); the segment score: (Q +
  `r_s_bias`) against `seg_embed`'s row 1 where the query's and the key's
  token types differ, row 0 where they agree (none when no token types
  are passed); (content + position + segment) / sqrt(d_head), minus 1e30
  where masked; softmax, times V, `o` back to d_model, then
  `layer_norm(+ the layer input)`; the feed-forward `layer_1`,
  `ff_activation` (models/activations.py), `layer_2`, `layer_norm(+ its
  input)`;
- the mask, as XLNetModel builds it: a key is masked where it is padding
  (`1 - attention_mask`), but a query always sees itself (the non-target
  mask subtracts the identity), so a pad query of a left-padded row
  attends to the real tokens and to itself.

`mem_len`, `reuse_len`, `same_length` and `use_mems_*` change nothing in a
bidirectional forward without memory. Refused by name: `bi_data: true`
(transformers then gives the first half of a batch forward positions and
the second half backward ones, so a text's vector depends on its place in
the batch; it raises on an odd batch and returns no row for a batch of
one, a query), `attn_type` `uni`
(transformers' XLNetModel raises when it adds an attention mask to its
causal mask for a batch of more than one text, so the reference's encoder
cannot embed a document batch), any other `attn_type`, and a `d_head`
other than d_model / heads (transformers raises on both).

Parameter names are `XLNetModel`'s (`word_embedding.weight`, `mask_emb`,
held though the content stream never reads it,
`layer.{i}.rel_attn.{q,k,v,o,r,r_w_bias,r_r_bias,r_s_bias,seg_embed}`,
`layer.{i}.rel_attn.layer_norm.weight`, `layer.{i}.ff.layer_1.weight`,
...), so a checkpoint's tensors load by name (models/checkpoint.py drops
the `transformer.` prefix).

Everything runs in float32. On a CUDA device the forward raises when
`torch.backends.cuda.matmul.allow_tf32` is set, as models/bert.py does.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional

import torch
from torch import nn

from .activations import activation

MODEL_TYPE = "xlnet"
# XLNetConfig's defaults for what a config.json may leave out
DEFAULTS = {"vocab_size": 32000, "d_model": 1024, "n_layer": 24, "n_head": 16,
            "d_inner": 4096, "ff_activation": "gelu", "attn_type": "bi",
            "layer_norm_eps": 1e-12, "bi_data": False, "clamp_len": -1, "pad_token_id": 5}
MASKED = 1e30  # XLNet's float32 masking constant
INIT_STD = 0.02  # XLNetConfig's initializer_range


def check_config(config: dict) -> dict:
    """Raise ValueError unless `config` describes an XLNet this module runs;
    return it with XLNetConfig's defaults and BERT's width names
    (`hidden_size`, `num_hidden_layers`, `num_attention_heads`,
    `intermediate_size`) for models/hf_encoder.py."""
    config = {**DEFAULTS, **config}
    d, heads = config["d_model"], config["n_head"]
    if d % heads:
        raise ValueError("d_model is not a multiple of n_head")
    if config.get("d_head") not in (None, d // heads):
        raise ValueError(f"d_head {config['d_head']} is not d_model // n_head = {d // heads}:"
                         " transformers' XLNetConfig raises on it")
    activation(config["ff_activation"], "ff_activation")
    if config["attn_type"] == "uni":
        raise ValueError("attn_type `uni` is not supported: transformers' XLNetModel raises on"
                         " its attention mask for a batch of more than one text")
    if config["attn_type"] != "bi":
        raise ValueError(f"attn_type `{config['attn_type']}` is not supported: transformers'"
                         " XLNet runs bi (and uni)")
    if config["bi_data"]:
        raise ValueError("bi_data: true is not supported: transformers gives the two halves of a"
                         " batch different positions (raises on an odd batch and returns no row"
                         " for one text), so a text's vector would depend on its batch")
    return {**config, "d_head": d // heads, "hidden_size": d, "num_hidden_layers":
            config["n_layer"], "num_attention_heads": heads, "intermediate_size":
            config["d_inner"]}


@lru_cache(maxsize=32)
def positional_encoding(qlen: int, d_model: int, clamp_len: int) -> torch.Tensor:
    """The (2 qlen, d_model) float32 relative position table of
    `XLNetModel.relative_positional_encoding` for `bi` without memory (klen
    = qlen): the same torch ops, on the CPU."""
    freq_seq = torch.arange(0, d_model, 2.0, dtype=torch.int64).float()
    inv_freq = 1 / torch.pow(10000, (freq_seq / d_model))
    pos_seq = torch.arange(qlen, -qlen, -1.0, dtype=torch.int64).float()
    if clamp_len > 0:
        pos_seq = pos_seq.clamp(-clamp_len, clamp_len)
    sinusoid = torch.einsum("i,d->id", pos_seq, inv_freq)
    return torch.cat([torch.sin(sinusoid), torch.cos(sinusoid)], dim=-1)


def rel_shift_bnij(x: torch.Tensor, klen: int) -> torch.Tensor:
    """transformers' `XLNetRelativeAttention.rel_shift_bnij`: (b, n, i, P)
    position scores to (b, n, i, klen), query i reading key j's relative
    distance i - j."""
    b, n, i, p = x.shape
    x = x.reshape(b, n, p, i)[:, :, 1:, :].reshape(b, n, i, p - 1)
    return x[:, :, :, :klen]


def masked_keys(attention_mask: torch.Tensor) -> torch.Tensor:
    """(B, L, L) float32, 1 where query i may not read key j: XLNetModel's
    `non_tgt_mask` for `bi` without memory."""
    L = attention_mask.shape[1]
    data = (1.0 - attention_mask.to(torch.float32))[:, None, :]  # padded keys
    eye = torch.eye(L, device=attention_mask.device)
    return ((data > 0).to(torch.float32) - eye > 0).to(torch.float32)


class _RelativeAttention(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        d, n, h = c["d_head"], c["n_head"], c["d_model"]
        self.scale = 1 / (d ** 0.5)
        # XLNetPreTrainedModel's initialization, normal(0, 0.02)
        for name in ("q", "k", "v", "o", "r"):
            setattr(self, name, nn.Parameter(torch.randn(h, n, d) * INIT_STD))
        for name in ("r_r_bias", "r_s_bias", "r_w_bias"):
            setattr(self, name, nn.Parameter(torch.randn(n, d) * INIT_STD))
        self.seg_embed = nn.Parameter(torch.randn(2, n, d) * INIT_STD)
        self.layer_norm = nn.LayerNorm(h, eps=c["layer_norm_eps"])

    def forward(self, x: torch.Tensor, masked: torch.Tensor, pos: torch.Tensor,
                differ: Optional[torch.Tensor]) -> torch.Tensor:
        L = x.shape[1]
        q = torch.einsum("bih,hnd->bind", x, self.q)
        k = torch.einsum("bih,hnd->bind", x, self.k)
        v = torch.einsum("bih,hnd->bind", x, self.v)
        k_r = torch.einsum("jh,hnd->jnd", pos, self.r)
        ac = torch.einsum("bind,bjnd->bnij", q + self.r_w_bias, k)
        bd = rel_shift_bnij(torch.einsum("bind,jnd->bnij", q + self.r_r_bias, k_r), L)
        score = ac + bd
        if differ is not None:  # the segment term, row 1 where the types differ
            ef = torch.einsum("bind,snd->bnis", q + self.r_s_bias, self.seg_embed)
            score = score + torch.where(differ[:, None], ef[..., 1:], ef[..., :1])
        score = score * self.scale - MASKED * masked[:, None]
        probs = torch.softmax(score, dim=3)
        out = torch.einsum("bnij,bjnd->bind", probs, v)
        return self.layer_norm(torch.einsum("bind,hnd->bih", out, self.o) + x)


class _FeedForward(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        self.layer_norm = nn.LayerNorm(c["d_model"], eps=c["layer_norm_eps"])
        self.layer_1 = nn.Linear(c["d_model"], c["d_inner"])
        self.layer_2 = nn.Linear(c["d_inner"], c["d_model"])
        self.act = activation(c["ff_activation"], "ff_activation")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layer_norm(self.layer_2(self.act(self.layer_1(x))) + x)


class _Layer(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        self.rel_attn = _RelativeAttention(c)
        self.ff = _FeedForward(c)

    def forward(self, x, masked, pos, differ) -> torch.Tensor:
        return self.ff(self.rel_attn(x, masked, pos, differ))


class XLNetModel(nn.Module):
    """XLNet's content stream, widths from a transformers-style config
    dict (XLNetConfig's names, defaults filled in)."""

    reads_token_types = True  # the segment term compares the tokenizer's types

    def __init__(self, config: dict):
        super().__init__()
        config = check_config(config)
        self.config = config
        self.word_embedding = nn.Embedding(config["vocab_size"], config["d_model"])
        self.mask_emb = nn.Parameter(torch.randn(1, 1, config["d_model"]) * INIT_STD)
        self.layer = nn.ModuleList(_Layer(config) for _ in range(config["n_layer"]))

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, L) int64 ids, 0/1 mask and (optionally) token types -> (B, L,
        d_model) float32, the last hidden state."""
        if input_ids.is_cuda and torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError(
                "the text encoder needs full float32 matmuls:"
                " torch.backends.cuda.matmul.allow_tf32 is True"
            )
        c = self.config
        x = self.word_embedding(input_ids)
        masked = masked_keys(attention_mask)
        pos = positional_encoding(input_ids.shape[1], c["d_model"], c["clamp_len"]).to(x.device)
        differ = None
        if token_type_ids is not None:
            differ = token_type_ids[:, :, None] != token_type_ids[:, None, :]
        for layer in self.layer:
            x = layer(x, masked, pos, differ)
        return x
