"""The sparse mixture-of-experts block of the MoE decoders (the port's K8
for `model_type` `mixtral`, `qwen2_moe` and `qwen3_moe`: GritLM-8x7B,
Mixtral, Qwen1.5-MoE, Qwen3-MoE), as transformers' `MixtralSparseMoeBlock`,
`Qwen2MoeSparseMoeBlock` and `Qwen3MoeSparseMoeBlock` compute it in eval:

- the (B, L, hidden) input flattened to (B·L, hidden) rows, every row
  routed, pads included (no capacity limit, nothing dropped);
- `gate`, one bias-free Linear to the experts' logits over all rows;
- the routing weights: a float32 softmax over the experts, then
  `torch.topk(num_experts_per_tok)`; divided by their sum for `mixtral`
  always, for the Qwen types under `norm_topk_prob`;
- each expert a gated MLP, `down(act(gate(x)) * up(x))` (Mixtral's
  `w2(act(w1(x)) * w3(x))`), run over the rows routed to it, times each
  row's routing weight, and `index_add_` into zeros, one expert after
  another in ascending index (a row's sum in that order: for a top-2 it
  cannot change a bit, for Qwen's top-4 and top-8 it can);
- for `qwen2_moe`, the shared expert over every row
  (`shared_expert_intermediate_size`) times `sigmoid(shared_expert_gate(x))`,
  added after the routed sum.

The rows of each expert are gathered in the reference's order (its
`torch.where` over the (top_k, rows) one-hot: by routing slot, then by
row), so that on the CPU each expert's products see the same matrix as
the reference's and the result is the reference's bit for bit. The rows
are grouped by one stable sort of the (slot, row) pairs by expert on the
device; the count of rows per expert is read on the host once a block
(the reference's `nonzero` syncs once a block too, and its `where` once
an expert).

Parameter names are transformers': `gate.weight`,
`experts.{j}.{w1,w2,w3}.weight` (Mixtral's gate, down and up
projections) or `experts.{j}.{gate,up,down}_proj.weight`, and Qwen2-MoE's
`shared_expert.{gate,up,down}_proj.weight` and `shared_expert_gate.weight`.
"""

from __future__ import annotations

import torch
from torch import nn

MIXTRAL = "mixtral"
QWEN2_MOE = "qwen2_moe"
QWEN3_MOE = "qwen3_moe"
MODEL_TYPES = (MIXTRAL, QWEN2_MOE, QWEN3_MOE)


def num_experts(c: dict) -> int:
    """The config's expert count (Mixtral's `num_local_experts`)."""
    return c["num_local_experts"] if c["model_type"] == MIXTRAL else c["num_experts"]


def expert_width(c: dict) -> int:
    """An expert's intermediate width (Mixtral's `intermediate_size`)."""
    return c["intermediate_size"] if c["model_type"] == MIXTRAL else c["moe_intermediate_size"]


def is_sparse(c: dict, layer: int) -> bool:
    """Whether decoder layer `layer` takes the sparse block: every Mixtral
    layer; a Qwen layer with experts, not in `mlp_only_layers`, every
    `decoder_sparse_step`-th (`Qwen3MoeDecoderLayer.__init__`)."""
    if c["model_type"] == MIXTRAL:
        return True
    return (layer not in c["mlp_only_layers"] and c["num_experts"] > 0
            and (layer + 1) % c["decoder_sparse_step"] == 0)


def check_config(c: dict) -> None:
    """Raise ValueError where transformers raises: a `decoder_sparse_step`
    of 0 that a layer's test divides by, or more experts a token than a
    sparse layer has (`torch.topk` raises)."""
    kind, k, n = c["model_type"], c["num_experts_per_tok"], num_experts(c)
    layers = range(c["num_hidden_layers"])
    if kind != MIXTRAL and c["decoder_sparse_step"] == 0 and c["num_experts"] > 0 \
            and any(i not in c["mlp_only_layers"] for i in layers):
        raise ValueError("decoder_sparse_step 0 is not supported: transformers' layer test"
                         " divides by it")
    uses = kind == MIXTRAL or any(is_sparse(c, i) for i in layers)
    if uses and not 0 <= k <= n:
        raise ValueError(f"num_experts_per_tok {k} is not supported over {n} experts:"
                         " transformers' torch.topk raises")


class Expert(nn.Module):
    """One gated MLP without biases, under Mixtral's names (`w1` gate, `w3`
    up, `w2` down) or the Qwen types' (`gate_proj`, `up_proj`,
    `down_proj`)."""

    def __init__(self, hidden: int, width: int, act, mixtral: bool):
        super().__init__()
        names = ("w1", "w3", "w2") if mixtral else ("gate_proj", "up_proj", "down_proj")
        self.names = names
        setattr(self, names[0], nn.Linear(hidden, width, bias=False))
        setattr(self, names[1], nn.Linear(hidden, width, bias=False))
        setattr(self, names[2], nn.Linear(width, hidden, bias=False))
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gate, up, down = (getattr(self, n) for n in self.names)
        return down(self.act(gate(x)) * up(x))


class SparseMoeBlock(nn.Module):
    """The sparse block of a `mixtral`, `qwen2_moe` or `qwen3_moe` config
    (defaults filled in); `act`, the config's activation."""

    def __init__(self, c: dict, act):
        super().__init__()
        kind, h = c["model_type"], c["hidden_size"]
        self.top_k = c["num_experts_per_tok"]
        self.normalize = kind == MIXTRAL or bool(c["norm_topk_prob"])
        self.gate = nn.Linear(h, num_experts(c), bias=False)
        self.experts = nn.ModuleList(Expert(h, expert_width(c), act, kind == MIXTRAL)
                                     for _ in range(num_experts(c)))
        self.shared = kind == QWEN2_MOE
        if self.shared:
            self.shared_expert = Expert(h, c["shared_expert_intermediate_size"], act, False)
            self.shared_expert_gate = nn.Linear(h, 1, bias=False)

    def route(self, rows: torch.Tensor) -> tuple:
        """(weights, experts): each row's top_k routing weights (in the
        rows' dtype) and experts, from the gate's logits."""
        logits = self.gate(rows)
        weights = torch.softmax(logits, dim=1, dtype=torch.float32)
        weights, chosen = torch.topk(weights, self.top_k, dim=-1)
        if self.normalize:
            weights = weights / weights.sum(dim=-1, keepdim=True)
        return weights.to(rows.dtype), chosen

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, L, h = x.shape
        rows = x.reshape(-1, h)
        n = rows.shape[0]
        weights, chosen = self.route(rows)
        out = torch.zeros_like(rows)
        # the (slot, row) pairs in the reference's order, grouped by expert
        experts = chosen.t().reshape(-1)
        order = torch.argsort(experts, stable=True)
        counts = torch.bincount(experts, minlength=len(self.experts)).tolist()
        routed_rows = order % n
        routed_weights = weights.t().reshape(-1)[order, None]
        start = 0
        for expert, count in zip(self.experts, counts):
            if count == 0:
                continue
            at = routed_rows[start : start + count]
            y = expert(rows.index_select(0, at)) * routed_weights[start : start + count]
            out.index_add_(0, at, y)
            start += count
        if self.shared:
            shared = self.shared_expert(rows)
            out = out + torch.sigmoid(self.shared_expert_gate(rows)) * shared
        return out.reshape(B, L, h)
