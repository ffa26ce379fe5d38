"""Mixture-of-Experts FFN (``repro.models.moe.moe_apply``): top-k routing,
capacity-based sort dispatch (:func:`repro_torch.kernels.ops.moe_apply`),
optional shared experts (DeepSeek-style) and the Switch load-balance loss.

Expert weights are stacked ``[E, ...]`` as in the JAX package.  Its
expert-parallel ``shard_map`` path waits for the port's sharding slice;
this is the single-device path, which dispatches each batch row on its
own (capacity per (row, expert)).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import MoEConfig
from ..kernels import ops
from .layers import DEFAULT_COMPUTE_DTYPE, apply_mlp, cast


def route(p: Dict, x: torch.Tensor, cfg: MoEConfig, dtype) -> Tuple:
    """(probs [B,S,E] fp32, gates [B,S,K] fp32, experts [B,S,K] int64).

    The router's logits are taken in ``dtype`` and the softmax in fp32.
    ``jax.lax.top_k`` puts the lower expert first among equal
    probabilities, and bf16 logits make exact ties common; ``torch.topk``
    promises no order among them, so the top k are the first k of a
    stable descending sort.  Gates are renormalised over the k.
    """
    logits = (x @ cast(p["router"], dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = vals[..., :cfg.top_k], idx[..., :cfg.top_k]
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    return probs, gate, idx


def moe_apply(
    p: Dict,
    x: torch.Tensor,             # [B, S, D]
    cfg: MoEConfig,
    *,
    dtype=DEFAULT_COMPUTE_DTYPE,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (out [B,S,D], aux load-balance loss scalar)."""
    S = x.shape[1]
    probs, gate, idx = route(p, x, cfg, dtype)
    capacity = max(1, int(cfg.capacity_factor * cfg.top_k * S
                          // cfg.n_experts))
    y = ops.moe_apply(x, p["gate_w"], p["up_w"], p["down_w"], idx,
                      gate.to(dtype), capacity, dtype=dtype)
    if "shared" in p:
        y = y + apply_mlp(p["shared"], x, "swiglu", dtype)

    # Switch-style aux loss: E * sum_e f_e * P_e
    E = cfg.n_experts
    me = probs.reshape(-1, E).mean(dim=0)              # mean prob/expert
    ce = F.one_hot(idx[..., 0].reshape(-1), E).float().mean(dim=0)
    return y, E * torch.sum(me * ce)
