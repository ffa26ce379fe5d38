"""RecurrentGemma/Griffin recurrent block (``repro.models.rglru``): dual
input projections, causal conv1d, RG-LRU linear recurrence, gated output.

The recurrence is :func:`repro_torch.kernels.ops.rglru` (the CUDA kernel
on the card, its plain loop on the CPU).  Gate projections are block-
diagonal with the JAX package's 16 blocks.

Under a mesh the reference's hooks apply (``weight_for_batch`` on every
weight, ``channels`` on the recurrence's input and output) and the scan
and its decode step run on each rank's channels
(:mod:`repro_torch.sharding.calls`).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import RGLRUConfig
from ..kernels import ops
from ..sharding import calls
from ..sharding.annotate import NULL_SHARDER
from .layers import DEFAULT_COMPUTE_DTYPE, cast, gelu_tanh

N_GATE_BLOCKS = 16


def _block_linear(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
                  dtype) -> torch.Tensor:
    """x: [..., W] -> [..., W] with block-diagonal w [NB, blk, blk]."""
    nb, blk, _ = w.shape
    xb = x.reshape(x.shape[:-1] + (nb, blk))
    y = torch.einsum("...nk,nkj->...nj", xb, cast(w, dtype))
    return y.reshape(x.shape) + cast(b, dtype)


def _log_a(p: Dict) -> torch.Tensor:
    # log a = -softplus(a_param)  (guarantees a in (0,1))
    return -F.softplus(p["a_param"].float())


def _gates(p: Dict, conv: torch.Tensor, dtype, wcast=None):
    w = wcast if wcast is not None else (lambda t: t)
    ra = torch.sigmoid(_block_linear(w(p["gate_a"]), w(p["gate_a_b"]), conv,
                                     dtype).float())
    ri = torch.sigmoid(_block_linear(w(p["gate_i"]), w(p["gate_i_b"]), conv,
                                     dtype).float())
    return ra, ri


def rglru_block_apply(
    p: Dict,
    x: torch.Tensor,                    # [B, S, D]
    r: RGLRUConfig,
    *,
    backend: str = "kernel",
    initial_state: Optional[Dict] = None,
    shard=NULL_SHARDER,
    dtype=DEFAULT_COMPUTE_DTYPE,
) -> Tuple[torch.Tensor, Dict]:
    """Full-sequence recurrent block.  Returns (out, {"h", "conv"})."""
    B, S, _ = x.shape

    def wcast(w):
        return shard.weight_for_batch(cast(w, dtype), B)

    # the lru-width axis stays model-sharded through the recurrence
    u = shard.channels(x @ wcast(p["wx"]))                  # [B,S,W]
    gate_branch = gelu_tanh(x @ wcast(p["wy"]))
    W = r.conv_width
    prev = (initial_state["conv"] if initial_state
            else u.new_zeros((B, W - 1, u.shape[-1])))
    up = torch.cat([prev, u], dim=1)
    conv_w = wcast(p["conv_w"])
    conv = sum(up[:, i:i + S, :] * conv_w[i] for i in range(W)) \
        + wcast(p["conv_b"])
    conv = shard.channels(conv)
    ra, ri = _gates(p, conv, dtype, wcast)
    h0 = initial_state["h"] if initial_state else None
    scan = ops.rglru if shard.mesh is None else \
        (lambda *a, **k: calls.rglru(shard, *a, **k))
    h, hT = scan(conv, ra, ri, _log_a(p), initial_state=h0, backend=backend)
    h = shard.channels(h)
    y = (h * gate_branch) @ wcast(p["out"])
    return y, {"h": hT, "conv": up[:, -(W - 1):, :]}


def rglru_block_decode(
    p: Dict,
    x: torch.Tensor,                    # [B, D]
    state: Dict,                        # {"h": [B,W], "conv": [B,W-1,C]}
    r: RGLRUConfig,
    *,
    shard=NULL_SHARDER,
    dtype=DEFAULT_COMPUTE_DTYPE,
) -> Tuple[torch.Tensor, Dict]:
    """One token.  Returns (out [B, D], new state dict)."""
    u = (x @ cast(p["wx"], dtype))[:, None, :]              # [B,1,W]
    gate_branch = gelu_tanh(x @ cast(p["wy"], dtype))
    hist = torch.cat([state["conv"], u], dim=1)             # [B,Wc,C]
    conv = torch.einsum("bwc,wc->bc", hist, cast(p["conv_w"], dtype)) \
        + cast(p["conv_b"], dtype)
    ra, ri = _gates(p, conv, dtype)
    step = ops.rglru_decode_step if shard.mesh is None else \
        (lambda *a: calls.rglru_decode_step(shard, *a))
    h, new_h = step(conv, ra, ri, _log_a(p), state["h"])
    y = (h * gate_branch) @ cast(p["out"], dtype)
    return y, {"h": new_h, "conv": hist[:, 1:]}
