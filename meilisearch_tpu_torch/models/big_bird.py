"""BigBird's block-sparse attention (the port's K8 for `model_type`
`big_bird` with `attention_type` `block_sparse`), which models/bert.py's
self-attention runs on a batch longer than the config's threshold.

It computes what transformers' torch `BigBirdModel` computes in eval, as
a fresh model computes it, when the JAX package's encoder
(`models/hf_encoder.py` there) runs it through its torch branch:

- `BigBirdModel.forward` runs full attention on a batch of at most
  (5 + 2 num_random_blocks) block_size tokens (`sparse_threshold`).
  transformers then switches the model to full attention for good
  (`set_attention_type("original_full")` is never undone: fault 3.28);
  the port keeps no attention type, and decides for each forward by the
  batch's padded length alone.
- A longer batch is padded to a multiple of block_size (`pad_to_block`):
  the pad id, mask 0, positions going on from 0 through the padding,
  token type 0; those rows are cut from the output. A padded length past
  `max_position_embeddings` is refused by name: transformers' embeddings
  slice their position ids to the table's length and fail to add them.
- In eval the random blocks are all block 0 (both rand-mask builders
  return zeros when not training). So query block i of nb sees key
  blocks: every one for i = 0 and i = nb - 1; 0, 1, 2 and nb - 1 for
  i = 1; 0, nb - 3, nb - 2 and nb - 1 for i = nb - 2; i - 1, i, i + 1, 0
  and nb - 1 for the others; and for 1 <= i <= nb - 2 block 0 r more
  times. Each softmax counts those keys 1 + r times.

`attention` runs this as one dense (L, L) product per head: scores
(Q K^T) * (1 / sqrt(d)) (`rsqrt_d`, after the product), plus log(1 + r)
on block 0's columns for query blocks 1 to nb - 2 (`Layout.weight`),
scores outside the pattern or of a padded key REPLACED by
finfo(float32).min (transformers adds -10000 to a padded key's score;
every real query sees a real key of its own block, so the rows agree),
softmax, then the probabilities of every padded query set to 0
(transformers multiplies their context by `from_mask`; the full path
does not), times V. At the encoder's 512 tokens that is the full path's
work and memory. Everything runs in float32, in explicit products, not
`scaled_dot_product_attention`.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import NamedTuple

import torch

from ..ops.chain_keys import LaunchCounter

FORWARDS = LaunchCounter()  # forwards that ran block-sparse, any device


def sparse_threshold(config: dict) -> int:
    """The longest batch a BigBird config runs with full attention:
    (5 + 2 num_random_blocks) block_size (`BigBirdModel.forward`'s
    `max_tokens_to_attend`)."""
    return (5 + 2 * config["num_random_blocks"]) * config["block_size"]


def pad_to_block(input_ids: torch.Tensor, attention_mask: torch.Tensor, block: int,
                 pad_id: int, max_positions: int) -> tuple:
    """(ids, mask) padded on the right to a multiple of `block` with
    `pad_id` and mask 0, as `BigBirdModel._pad_to_block_size` pads them."""
    L = input_ids.shape[1]
    n = -L % block
    if L + n > max_positions:
        raise ValueError(f"a batch of {L} tokens pads to {L + n}, a multiple of block_size"
                         f" {block}, past max_position_embeddings {max_positions}: transformers'"
                         " BigBird embeddings cannot add its positions")
    if n == 0:
        return input_ids, attention_mask
    return (torch.nn.functional.pad(input_ids, (0, n), value=pad_id),
            torch.nn.functional.pad(attention_mask, (0, n), value=0))


@lru_cache(maxsize=32)
def block_counts(nb: int, r: int) -> torch.Tensor:
    """(nb, nb) int64: how many times query block i's softmax counts key
    block j (0 outside the pattern). On the CPU."""
    i = torch.arange(nb)[:, None]
    j = torch.arange(nb)[None, :]
    seen = ((i - j).abs() <= 1) | (j == 0) | (j == nb - 1) | (i == 0) | (i == nb - 1)
    middle = (i >= 1) & (i <= nb - 2)
    return seen.long() + r * ((j == 0) & middle).long()


class Layout(NamedTuple):
    """One forward's pattern: `blocked` (B, 1, L, L) bool, a key outside
    the pattern or padded; `weight` (1, 1, L, L) float32, the log of each
    key's count inside the pattern; `pad_queries` (B, 1, L, 1) bool."""

    blocked: torch.Tensor
    weight: torch.Tensor
    pad_queries: torch.Tensor


def layout(attention_mask: torch.Tensor, block: int, r: int) -> Layout:
    """The pattern of a batch padded to a multiple of `block` (`mask`,
    (B, L)), built once a forward on the mask's device."""
    L = attention_mask.shape[1]
    counts = block_counts(L // block, r).to(attention_mask.device)
    counts = counts.repeat_interleave(block, 0).repeat_interleave(block, 1)
    weight = torch.where(counts > 1, counts.float().log(), torch.zeros((), device=counts.device))
    pad = attention_mask == 0
    return Layout((counts == 0)[None, None] | pad[:, None, None, :],
                  weight[None, None], pad[:, None, :, None])


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lay: Layout) -> torch.Tensor:
    """(B, heads, L, d) q, k, v -> (B, heads, L, d), block-sparse."""
    scores = torch.matmul(q, k.transpose(-1, -2)).mul_(1 / math.sqrt(q.shape[-1]))
    scores.add_(lay.weight).masked_fill_(lay.blocked, torch.finfo(scores.dtype).min)
    probs = torch.softmax(scores, dim=-1).masked_fill_(lay.pad_queries, 0.0)
    return torch.matmul(probs, v)
