"""The 1-D convolution of the port's SqueezeBERT (models/squeezebert.py)
and DeBERTa-v2's ConvLayer (models/deberta_v2.py): `nn.Conv1d`'s function
(stride 1, no dilation, zero padding on both sides, `groups`) written as
a grouped float32 product, so that on a CUDA device it runs through the
matmul kernels (full float32: models/bert.py raises when
`torch.backends.cuda.matmul.allow_tf32` is set) and not through cuDNN,
whose convolutions take TF32 by default (`torch.backends.cudnn.allow_tf32`).

`Conv1d` keeps `nn.Conv1d`'s parameters, (out, in / groups, kernel) weight
and (out,) bias, so a checkpoint's tensors load by name; only its forward
is this module's. Group g's outputs read group g's inputs only, the
block-diagonal product a dense one would not give.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def conv1d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, padding: int = 0,
           groups: int = 1) -> torch.Tensor:
    """(N, C, W) -> (N, out, W + 2 padding - kernel + 1), as F.conv1d."""
    n, _c, _w = x.shape
    out, per_group, k = weight.shape
    if padding:
        x = F.pad(x, (padding, padding))
    cols = x.unfold(2, k, 1)  # (N, C, W', k)
    width = cols.shape[2]
    cols = cols.reshape(n, groups, per_group, width, k)
    w = weight.view(groups, out // groups, per_group, k)
    y = torch.einsum("ngcwk,gock->ngow", cols, w).reshape(n, out, width)
    return y + bias[:, None]


class Conv1d(nn.Conv1d):
    """`nn.Conv1d` (stride 1, symmetric zero padding) whose forward is
    `conv1d`."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv1d(x, self.weight, self.bias, self.padding[0], self.groups)
