"""Mamba-2 block (``repro.models.ssm``): per-component projections ->
causal conv1d -> SSD mixer -> gated RMSNorm -> out-projection.

The SSD scan itself is :func:`repro_torch.kernels.ops.ssd` (the CUDA
kernel on the card, its plain chunked version on the CPU).  Weights keep
the JAX package's separate x/B/C/dt/gate projections and shapes, so the
weight bridge copies them unchanged.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import SSMConfig
from ..kernels import ops
from .layers import DEFAULT_COMPUTE_DTYPE, apply_norm, cast


def _heads(s: SSMConfig) -> int:
    return s.d_inner // s.head_dim


def _causal_conv(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
                 prev: Optional[torch.Tensor] = None):
    """Depthwise causal conv over [B, S, C]; ``prev`` is [B, W-1, C].
    Returns (silu(conv + b), the last W-1 inputs)."""
    W = w.shape[0]
    if prev is None:
        prev = x.new_zeros((x.shape[0], W - 1, x.shape[2]))
    xp = torch.cat([prev, x], dim=1)
    out = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(W))
    return F.silu(out + b), xp[:, -(W - 1):, :]


def mamba2_apply(
    p: Dict,
    x: torch.Tensor,                    # [B, S, D]
    s: SSMConfig,
    *,
    backend: str = "kernel",
    initial_state: Optional[Dict] = None,
    dtype=DEFAULT_COMPUTE_DTYPE,
) -> Tuple[torch.Tensor, Dict]:
    """Full-sequence mamba2 mixer.  Returns (out, state dict)."""
    B, S, _ = x.shape
    heads = _heads(s)
    gate = x @ cast(p["w_gate"], dtype)
    xs_r = x @ cast(p["w_x"], dtype)
    b_r = x @ cast(p["w_b"], dtype)
    c_r = x @ cast(p["w_c"], dtype)
    dt_r = x @ cast(p["w_dt"], dtype)

    prev = initial_state if initial_state else {}
    xs_c, conv_x = _causal_conv(cast(p["conv_x_w"], dtype),
                                cast(p["conv_x_b"], dtype), xs_r,
                                prev.get("conv_x"))
    b_c, conv_b = _causal_conv(cast(p["conv_b_w"], dtype),
                               cast(p["conv_b_b"], dtype), b_r,
                               prev.get("conv_b"))
    c_c, conv_c = _causal_conv(cast(p["conv_c_w"], dtype),
                               cast(p["conv_c_b"], dtype), c_r,
                               prev.get("conv_c"))

    xs = xs_c.reshape(B, S, heads, s.head_dim)
    Bmat = b_c.reshape(B, S, s.n_groups, s.state_dim)
    Cmat = c_c.reshape(B, S, s.n_groups, s.state_dim)
    dt = F.softplus(dt_r.float() + p["dt_bias"])
    A = -torch.exp(p["a_log"].float())
    y, hT = ops.ssd(xs, dt, A, Bmat, Cmat, chunk=s.chunk,
                    initial_state=prev.get("ssm"), backend=backend)
    y = y + xs * cast(p["d_skip"], dtype)[None, None, :, None]
    y = y.reshape(B, S, s.d_inner)
    y = apply_norm(p["gate_norm"], y) * F.silu(gate)
    out = y @ cast(p["out_proj"], dtype)
    return out, {"ssm": hT, "conv_x": conv_x, "conv_b": conv_b,
                 "conv_c": conv_c}


def mamba2_decode(
    p: Dict,
    x: torch.Tensor,                    # [B, D]
    state: Dict,
    s: SSMConfig,
    *,
    dtype=DEFAULT_COMPUTE_DTYPE,
) -> Tuple[torch.Tensor, Dict]:
    """One token.  Returns (out [B, D], new state dict)."""
    B, _ = x.shape
    heads = _heads(s)
    gate = x @ cast(p["w_gate"], dtype)
    xs_r = (x @ cast(p["w_x"], dtype))[:, None, :]
    b_r = (x @ cast(p["w_b"], dtype))[:, None, :]
    c_r = (x @ cast(p["w_c"], dtype))[:, None, :]
    dt_r = x @ cast(p["w_dt"], dtype)

    def conv_step(wk, bk, u, hist):
        h = torch.cat([hist, u], dim=1)                          # [B,W,C]
        out = torch.einsum("bwc,wc->bc", h, cast(wk, dtype)) + cast(bk, dtype)
        return F.silu(out), h[:, 1:]

    xs_c, conv_x = conv_step(p["conv_x_w"], p["conv_x_b"], xs_r,
                             state["conv_x"])
    b_c, conv_b = conv_step(p["conv_b_w"], p["conv_b_b"], b_r,
                            state["conv_b"])
    c_c, conv_c = conv_step(p["conv_c_w"], p["conv_c_b"], c_r,
                            state["conv_c"])

    xs = xs_c.reshape(B, heads, s.head_dim)
    Bvec = b_c.reshape(B, s.n_groups, s.state_dim)
    Cvec = c_c.reshape(B, s.n_groups, s.state_dim)
    dt = F.softplus(dt_r.float() + p["dt_bias"])
    A = -torch.exp(p["a_log"].float())
    y, new_ssm = ops.ssd_decode_step(xs, dt, A, Bvec, Cvec, state["ssm"])
    y = y + xs * cast(p["d_skip"], dtype)[None, :, None]
    y = y.reshape(B, s.d_inner)
    y = apply_norm(p["gate_norm"], y) * F.silu(gate)
    out = y @ cast(p["out_proj"], dtype)
    return out, {"ssm": new_ssm, "conv_x": conv_x, "conv_b": conv_b,
                 "conv_c": conv_c}
