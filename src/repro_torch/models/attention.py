"""GQA attention with prefill and decode entry points and cross attention
(``repro.models.attention.gqa_apply`` / ``gqa_decode`` / ``cross_kv`` /
``cross_apply``).

Weights stay head-major as in the JAX package (``wq [d_model, H, hd]``,
``wo [H, hd, d_model]``), so the weight bridge copies them unchanged.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..kernels import ops
from .layers import DEFAULT_COMPUTE_DTYPE, apply_rope, cast


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk")`` as one matrix product."""
    return (x @ w.flatten(1)).unflatten(-1, w.shape[1:])


def _qkv(p: Dict, x: torch.Tensor, dtype) -> Tuple:
    q = _proj(x, cast(p["wq"], dtype))
    k = _proj(x, cast(p["wk"], dtype))
    v = _proj(x, cast(p["wv"], dtype))
    if "bq" in p:
        q = q + cast(p["bq"], dtype)
        k = k + cast(p["bk"], dtype)
        v = v + cast(p["bv"], dtype)
    return q, k, v


def _out(p: Dict, o: torch.Tensor, dtype) -> torch.Tensor:
    """``einsum("bshk,hkd->bsd")`` as one matrix product."""
    y = o.flatten(-2) @ cast(p["wo"], dtype).flatten(0, 1)
    if "bo" in p:
        y = y + cast(p["bo"], dtype)
    return y


def gqa_apply(
    p: Dict,
    x: torch.Tensor,                   # [B, S, D]
    *,
    rope_theta: Optional[float],
    mask_kind: str = "causal",         # causal|window|none
    window: int = 0,
    positions: Optional[torch.Tensor] = None,
    backend: str = "kernel",
    dtype=DEFAULT_COMPUTE_DTYPE,
) -> Tuple[torch.Tensor, Dict]:
    """Full-sequence attention.  Returns (out [B,S,D], cache entries)."""
    S = x.shape[1]
    q, k, v = _qkv(p, x, dtype)
    if rope_theta is not None:
        pos = positions if positions is not None \
            else torch.arange(S, device=x.device)
        q = apply_rope(q, pos, rope_theta)
        k = apply_rope(k, pos, rope_theta)
    o = ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                            mask_kind=mask_kind, window=window,
                            backend=backend)
    return _out(p, o, dtype), {"k": k, "v": v}


def gqa_decode(
    p: Dict,
    x: torch.Tensor,                   # [B, D] one token
    cache: Dict,                       # {"k": [B,S,KV,hd], "v": ...}
    length: torch.Tensor,              # [B] int32 current cache fill
    *,
    rope_theta: Optional[float],
    window: int = 0,
    backend: str = "kernel",
    dtype=DEFAULT_COMPUTE_DTYPE,
) -> Tuple[torch.Tensor, Dict]:
    """One decode step: write this token's K/V at its slot and attend.

    The JAX package returns a new cache (``.at[bidx, slot].set``); here the
    token's K/V is written into ``cache`` in place, so a step copies one
    row per sequence instead of the whole cache.  The returned dict holds
    the same tensors.
    """
    B = x.shape[0]
    q, k, v = _qkv(p, x[:, None, :], dtype)            # [B,1,H,hd]
    if rope_theta is not None:
        pos = length[:, None]                          # [B,1]
        q = apply_rope(q, pos, rope_theta)
        k = apply_rope(k, pos, rope_theta)
    S = cache["k"].shape[1]
    ring = bool(window) and window < S
    slot = (length % window if ring else length).long()
    bidx = torch.arange(B, device=x.device)
    cache["k"][bidx, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][bidx, slot] = v[:, 0].to(cache["v"].dtype)
    eff_len = torch.clamp(length + 1, max=window if ring else S).to(
        torch.int32)
    o = ops.decode_attention(q[:, 0].contiguous(), cache["k"], cache["v"],
                             eff_len, backend=backend)
    y = _out(p, o[:, None, :, :], dtype)[:, 0]
    return y, cache


# ----------------------------------------------------------------- cross
def cross_kv(p: Dict, enc_out: torch.Tensor,
             dtype=DEFAULT_COMPUTE_DTYPE) -> Dict:
    """The encoder's keys and values for cross attention, computed once a
    sequence (prefill keeps them in the cache): {"k", "v"} [B, Se, KV,
    hd]."""
    k = _proj(enc_out, cast(p["wk"], dtype))
    v = _proj(enc_out, cast(p["wv"], dtype))
    if "bk" in p:
        k = k + cast(p["bk"], dtype)
        v = v + cast(p["bv"], dtype)
    return {"k": k, "v": v}


def cross_apply(
    p: Dict,
    x: torch.Tensor,                   # [B, Sq, D] decoder states
    enc_kv: Dict,                      # {"k": [B,Se,KV,hd], "v": ...}
    *,
    backend: str = "kernel",
    dtype=DEFAULT_COMPUTE_DTYPE,
) -> torch.Tensor:
    """Cross attention of the decoder states over the encoder's keys and
    values, no mask, through the flash kernel as in the JAX package (a
    decode step's Sq is 1)."""
    q = _proj(x, cast(p["wq"], dtype))
    if "bq" in p:
        q = q + cast(p["bq"], dtype)
    o = ops.flash_attention(q.contiguous(), enc_kv["k"].contiguous(),
                            enc_kv["v"].contiguous(), mask_kind="none",
                            backend=backend)
    return _out(p, o, dtype)
