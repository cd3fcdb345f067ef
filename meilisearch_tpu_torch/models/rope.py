"""Rotary position tables for the port's rotary models (models/modernbert.py,
models/decoder.py, models/gemma3.py).

The port's own copy of what transformers 4.57's `modeling_rope_utils`
computes for the rope types these families run: `default`, `linear`,
`dynamic`, `yarn`, `llama3` and `longrope`. `Rope.tables(n, device)` is
the `(cos, sin)` pair a rotary embedding module's forward returns for
positions 0..n-1 (the positions transformers gives every row of a batch
when no position ids are passed, left-padded rows included), each (1, 1,
n, dim) float32. The tables are built on the CPU with transformers' ops,
in its order and at its shapes (a Python-float product in another order
drifts in the last bit, and many layers amplify it), then copied to the
device, so every device rotates by the same bits:

- `default`: `inv_freq = 1 / theta ** (arange(0, dim, 2) / dim)`;
- `linear`: that, divided by `factor`;
- `dynamic`: for n <= `max_position_embeddings`, the NTK base at that
  length (which is `theta`); past it, the base at seq_len n, computed as
  `dynamic_rope_update` recomputes it, with seq_len a 0-d int64 tensor;
- `yarn`: the frequencies blended between `1 / pos_freqs` and
  `1 / (factor * pos_freqs)` by the linear ramp between the correction
  dimensions of `beta_fast` and `beta_slow` (floored and ceiled unless
  `truncate` is false) at `original_max_position_embeddings` (else
  `max_position_embeddings`); cos and sin are multiplied by
  `attention_factor` (given, or from `factor`, `mscale` and
  `mscale_all_dim`);
- `llama3`: the default frequencies, those of wavelength above
  `original_max_position_embeddings / low_freq_factor` divided by
  `factor`, those between that and `/ high_freq_factor` smoothed;
- `longrope`: `1 / (ext_factors * theta ** (arange(0, dim, 2) / dim))`
  with `short_factor`, or `long_factor` once n passes the config's own
  `original_max_position_embeddings` (else `max_position_embeddings`);
  cos and sin times `attention_factor` (given, or sqrt(1 + log(factor) /
  log(original)), `factor` being max / original where the config gives
  an original length).

`rope_scaling` names its type under `rope_type` or, in older files,
`type`. Refused by name (`check`), as transformers raises on each: an
unknown type or none at all, a type without its required keys, and
`longrope` with neither `factor` nor the config's
`original_max_position_embeddings`; also a `longrope` factor list that is
not dim / 2 long, or over an odd dim.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache
from typing import Optional

import torch

ROPE_TYPES = ("default", "linear", "dynamic", "yarn", "llama3", "longrope")
# the keys each type's transformers validation requires in rope_scaling
REQUIRED = {"default": (), "linear": ("factor",), "dynamic": ("factor",), "yarn": ("factor",),
            "llama3": ("factor", "low_freq_factor", "high_freq_factor",
                       "original_max_position_embeddings"),
            "longrope": ("short_factor", "long_factor")}
# the types whose tables depend on the batch's padded length n
BATCH_LENGTH_ROPES = ("dynamic", "longrope")
# the types whose transformers function reads `getattr(config, "head_dim",
# hidden // heads)`, so a config that stores head_dim None raises there
READS_STORED_HEAD_DIM = ("dynamic", "yarn", "longrope")


def rope_type(rope_scaling: Optional[dict]) -> Optional[str]:
    """The type a config's `rope_scaling` names, as the rotary modules read
    it (`rope_type`, else the older `type`); `default` for no scaling."""
    if rope_scaling is None:
        return "default"
    return rope_scaling.get("rope_type", rope_scaling.get("type"))


def _frozen(value):
    return tuple(value) if isinstance(value, list) else value


@dataclass(frozen=True)
class Rope:
    """One rotary embedding: its type, `theta` (rope_theta), the rotated
    width `dim` (head_dim), the config's `max_position_embeddings`, the
    `rope_scaling` items (lists as tuples, so a Rope hashes) and the
    config's own `original_max_position_embeddings` (longrope reads it
    there, not in rope_scaling)."""

    kind: str
    theta: float
    dim: int
    max_positions: Optional[int] = None
    scaling: tuple = ()
    original_max_positions: Optional[int] = None

    @classmethod
    def from_config(cls, config: dict, theta: float, dim: int) -> "Rope":
        """The rotary embedding of a config dict (its `rope_scaling`,
        `max_position_embeddings` and `original_max_position_embeddings`)
        at `theta` and `dim`, after `check`."""
        scaling = config.get("rope_scaling")
        original = config.get("original_max_position_embeddings")
        check(scaling, dim, original)
        return cls(rope_type(scaling), theta, dim, config.get("max_position_embeddings"),
                   tuple(sorted((k, _frozen(v)) for k, v in (scaling or {}).items())), original)

    def get(self, key: str, default=None):
        return dict(self.scaling).get(key, default)

    def inv_freq(self, n: int) -> tuple:
        """(inv_freq, attention_factor) for a batch of n positions."""
        return _INV_FREQ[self.kind](self, n)

    def tables(self, n: int, device: torch.device) -> tuple:
        """(cos, sin), each (1, 1, n, dim) float32 on `device`."""
        return _tables(self, n, torch.device(device))


def check(rope_scaling: Optional[dict], dim: int, original: Optional[int] = None) -> None:
    """Raise ValueError unless `rope_scaling` (None: the default) is one the
    port computes; `original`: the config's own
    `original_max_position_embeddings`."""
    kind = rope_type(rope_scaling)
    if kind not in ROPE_TYPES:
        raise ValueError(f"rope_scaling {rope_scaling} is not supported: its rope_type `{kind}` is"
                         f" not one of {ROPE_TYPES}")
    missing = [k for k in REQUIRED[kind] if k not in rope_scaling]
    if missing:
        raise ValueError(f"rope_scaling {rope_scaling} lacks {missing}, which rope_type `{kind}`"
                         " requires")
    if kind == "longrope":
        if rope_scaling.get("factor") is None and original is None:
            raise ValueError(f"rope_scaling {rope_scaling} is not supported: longrope needs a"
                             " factor or the config's original_max_position_embeddings")
        if dim % 2:
            raise ValueError(f"rope_scaling {rope_scaling} is not supported over an odd rotated"
                             f" width {dim}: its factor lists cannot match the (dim + 1) / 2"
                             " frequencies, and transformers raises")
        for key in ("short_factor", "long_factor"):
            if len(rope_scaling[key]) != dim // 2:
                raise ValueError(f"rope_scaling's {key} has {len(rope_scaling[key])} entries,"
                                 f" not head_dim / 2 = {dim // 2}")


def _exponents(dim: int) -> torch.Tensor:
    return torch.arange(0, dim, 2, dtype=torch.int64).to(dtype=torch.float) / dim


def _default(r: Rope, n: int) -> tuple:
    return 1.0 / (r.theta ** _exponents(r.dim)), 1.0


def _linear(r: Rope, n: int) -> tuple:
    inv_freq, attention = _default(r, n)
    inv_freq /= r.get("factor")
    return inv_freq, attention


def _dynamic(r: Rope, n: int) -> tuple:
    factor, longest = r.get("factor"), r.max_positions
    if n > longest:
        # dynamic_rope_update: seq_len = max(position_ids) + 1, an int64 tensor
        seq_len = torch.maximum(torch.tensor(n), torch.tensor(longest, dtype=torch.int64))
    else:
        seq_len = longest
    base = r.theta * ((factor * seq_len / longest) - (factor - 1)) ** (r.dim / (r.dim - 2))
    return 1.0 / (base ** _exponents(r.dim)), 1.0


def _yarn_mscale(scale, mscale=1):
    if scale <= 1:
        return 1.0
    return 0.1 * mscale * math.log(scale) + 1.0


def _yarn(r: Rope, n: int) -> tuple:
    base, dim, factor = r.theta, r.dim, r.get("factor")
    attention = r.get("attention_factor")
    mscale, mscale_all_dim = r.get("mscale"), r.get("mscale_all_dim")
    original = r.get("original_max_position_embeddings") or r.max_positions
    if attention is None:
        if mscale and mscale_all_dim:
            attention = float(_yarn_mscale(factor, mscale) / _yarn_mscale(factor, mscale_all_dim))
        else:
            attention = _yarn_mscale(factor)
    beta_fast = r.get("beta_fast") or 32
    beta_slow = r.get("beta_slow") or 1

    def correction_dim(rotations):
        return (dim * math.log(original / (rotations * 2 * math.pi))) / (2 * math.log(base))

    low, high = correction_dim(beta_fast), correction_dim(beta_slow)
    if r.get("truncate", True):
        low, high = math.floor(low), math.ceil(high)
    low, high = max(low, 0), min(high, dim - 1)
    if low == high:
        high += 0.001  # as transformers avoids the singularity
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32) - low) / (high - low), 0, 1)
    pos_freqs = base ** (torch.arange(0, dim, 2).to(dtype=torch.float) / dim)
    extrapolation, interpolation = 1.0 / pos_freqs, 1.0 / (factor * pos_freqs)
    extrapolation_factor = 1 - ramp
    inv_freq = (interpolation * (1 - extrapolation_factor)
                + extrapolation * extrapolation_factor)
    return inv_freq, attention


def _llama3(r: Rope, n: int) -> tuple:
    inv_freq, attention = _default(r, n)
    factor = r.get("factor")
    low_freq_factor, high_freq_factor = r.get("low_freq_factor"), r.get("high_freq_factor")
    old_context_len = r.get("original_max_position_embeddings")
    low_freq_wavelen = old_context_len / low_freq_factor
    high_freq_wavelen = old_context_len / high_freq_factor
    wavelen = 2 * math.pi / inv_freq
    inv_freq_llama = torch.where(wavelen > low_freq_wavelen, inv_freq / factor, inv_freq)
    smooth_factor = (old_context_len / wavelen - low_freq_factor) / (high_freq_factor
                                                                     - low_freq_factor)
    smoothed = (1 - smooth_factor) * inv_freq_llama / factor + smooth_factor * inv_freq_llama
    is_medium_freq = ~(wavelen < high_freq_wavelen) * ~(wavelen > low_freq_wavelen)
    return torch.where(is_medium_freq, smoothed, inv_freq_llama), attention


def _longrope(r: Rope, n: int) -> tuple:
    factor, attention = r.get("factor"), r.get("attention_factor")
    original = r.original_max_positions
    if original:
        factor = r.max_positions / original
    else:
        original = r.max_positions
    if attention is None:
        attention = 1.0 if factor <= 1.0 else math.sqrt(1 + math.log(factor) / math.log(original))
    key = "long_factor" if n > original else "short_factor"
    ext_factors = torch.tensor(r.get(key), dtype=torch.float32)
    shape = torch.arange(0, r.dim, 2, dtype=torch.int64).float() / r.dim
    return 1.0 / (ext_factors * r.theta ** shape), attention


_INV_FREQ = {"default": _default, "linear": _linear, "dynamic": _dynamic, "yarn": _yarn,
             "llama3": _llama3, "longrope": _longrope}


@lru_cache(maxsize=64)
def _tables(rope: Rope, n: int, device: torch.device) -> tuple:
    """The rotary module's forward at positions 0..n-1: the (1, dim/2, 1) @
    (1, 1, n) product, cos and sin of the doubled frequencies, times the
    attention factor."""
    inv_freq, attention = rope.inv_freq(n)
    positions = torch.arange(n).unsqueeze(0)
    freqs = (inv_freq[None, :, None].float() @ positions[:, None, :].float()).transpose(1, 2)
    emb = torch.cat((freqs, freqs), dim=-1)
    cos, sin = emb.cos() * attention, emb.sin() * attention
    return cos.unsqueeze(1).to(device), sin.unsqueeze(1).to(device)


def rotary(n: int, dim: int, theta: float, device: torch.device) -> tuple:
    """(cos, sin), each (1, 1, n, dim) float32 on `device`: transformers'
    default rotary embedding at `theta`."""
    return Rope("default", theta, dim).tables(n, device)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x[..., : x.shape[-1] // 2], x[..., x.shape[-1] // 2:]
    return torch.cat((-x2, x1), dim=-1)
