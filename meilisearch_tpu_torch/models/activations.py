"""The MLP activations of the port's encoders and decoders
(models/bert.py, models/albert.py, models/roformer.py, models/decoder.py,
models/gemma3.py, models/mobilebert.py, models/squeezebert.py, models/xlnet.py,
models/gpt_neo.py, models/gptj.py, models/bloom.py and DeBERTa-v2's
`conv_act`): its own copy of the transformers `ACT2FN` names it runs,
each written in torch as transformers writes it, so each gives the same
bits:

- `silu`, `swish`: `F.silu`;
- `gelu`: the exact (erf) `F.gelu`;
- `gelu_pytorch_tanh`: `F.gelu(approximate="tanh")`;
- `gelu_new`: `0.5 x (1 + tanh(sqrt(2 / pi) (x + 0.044715 x^3)))`, and
  `gelu_fast`: `0.5 x (1 + tanh(0.7978845608 x (1 + 0.044715 x x)))`,
  their explicit formulas (not torch's tanh GELU, which rounds
  otherwise);
- `quick_gelu`: `x sigmoid(1.702 x)`;
- `relu`: `F.relu`;
- `tanh`: `torch.tanh` (DeBERTa-v2's ConvLayer default).

Any other name is refused by name. BLOOM's MLP names no activation: it
runs `bloom_gelu` (`bloom_gelu_forward`, `x 0.5 (1 + tanh(0.79788456 x (1
+ 0.044715 x x)))`, a constant rounded otherwise than `gelu_new`'s
sqrt(2 / pi)), which models/bloom.py calls directly; no config name
reaches it.
"""

from __future__ import annotations

import math
from functools import partial

import torch
import torch.nn.functional as F


def gelu_new(x: torch.Tensor) -> torch.Tensor:
    inner = math.sqrt(2.0 / math.pi) * (x + 0.044715 * torch.pow(x, 3.0))
    return 0.5 * x * (1.0 + torch.tanh(inner))


def gelu_fast(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.tanh(x * 0.7978845608 * (1.0 + 0.044715 * x * x)))


def bloom_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * 0.5 * (1.0 + torch.tanh(0.79788456 * x * (1 + 0.044715 * x * x)))


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


ACTIVATIONS = {"silu": F.silu, "swish": F.silu, "gelu": F.gelu,
               "gelu_pytorch_tanh": partial(F.gelu, approximate="tanh"), "gelu_new": gelu_new,
               "gelu_fast": gelu_fast, "quick_gelu": quick_gelu, "relu": F.relu,
               "tanh": torch.tanh}


def activation(name: str, key: str = "hidden_act"):
    """The function of activation `name` (a config's `key`); ValueError
    for a name the port does not run."""
    if name not in ACTIVATIONS:
        raise ValueError(f"{key} `{name}` is not supported: the port runs {sorted(ACTIVATIONS)}")
    return ACTIVATIONS[name]
