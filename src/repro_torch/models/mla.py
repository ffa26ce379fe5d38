"""Multi-head Latent Attention, DeepSeek-V2 / MiniCPM3 (``repro.models.mla``).

Prefill uses the naive expansion (decompress the latent KV per position,
then flash attention with qk dim != v dim and the rope key broadcast over
the heads).  Decode uses the absorbed formulation on the compressed cache
``{"c_kv" [B,S,R], "k_rope" [B,S,r]}``: the query is projected into the
latent space, so a step reads ``R + r`` values per cached token.  Its
products are plain matrix products, as in the JAX package, which runs no
Pallas kernel there.

The flash kernels take the (D, Dv) pairs in ``flash_attention.HEAD_DIMS``
(the forward) and ``flash_attention_bwd.HEAD_DIMS`` (its backward).
Prefill zero-pads q and k along D to the smallest D' that pairs with the
value dim in both lists (minicpm3's qk 96 with v 64 runs as (128, 64), the
reduced configs' qk 48 with v 32 as (64, 32)), on every device; with the
scale passed explicitly, the padding leaves every score unchanged.  A
shape with no such pair is not padded, and the kernel refuses it on the
card.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..configs.base import MLAConfig
from ..kernels import ops
from ..kernels.flash_attention import HEAD_DIMS
from ..kernels.flash_attention_bwd import HEAD_DIMS as BWD_HEAD_DIMS
from .attention import _proj
from .layers import DEFAULT_COMPUTE_DTYPE, apply_norm, apply_rope, cast


def padded_qk_dim(qk_dim: int, v_dim: int) -> int:
    """The smallest D' >= ``qk_dim`` with (D', ``v_dim``) a pair that the
    flash kernel and its backward take, or ``qk_dim`` itself when there is
    none."""
    fits = [d for d, dv in HEAD_DIMS if dv == v_dim and d >= qk_dim
            and (d, dv) in BWD_HEAD_DIMS]
    return min(fits) if fits else qk_dim


def _queries(p: Dict, x: torch.Tensor, m: MLAConfig, rope_theta: float,
             positions: torch.Tensor, dtype) -> Tuple:
    if "wdq" in p:
        cq = apply_norm(p["q_norm"], x @ cast(p["wdq"], dtype))
        q = _proj(cq, cast(p["wuq"], dtype))
    else:
        q = _proj(x, cast(p["wq"], dtype))
    q_nope = q[..., :m.qk_nope_dim]
    q_rope = apply_rope(q[..., m.qk_nope_dim:], positions, rope_theta)
    return q_nope, q_rope


def mla_apply(
    p: Dict,
    x: torch.Tensor,                   # [B, S, D]
    m: MLAConfig,
    *,
    rope_theta: float,
    positions: Optional[torch.Tensor] = None,
    backend: str = "kernel",
    dtype=DEFAULT_COMPUTE_DTYPE,
) -> Tuple[torch.Tensor, Dict]:
    """Full-sequence MLA (naive expansion).  Returns (out [B,S,D], cache
    entries ``{"c_kv" [B,S,R], "k_rope" [B,S,r]}``)."""
    B, S, _ = x.shape
    pos = positions if positions is not None \
        else torch.arange(S, device=x.device)
    q_nope, q_rope = _queries(p, x, m, rope_theta, pos, dtype)

    c_kv = apply_norm(p["kv_norm"], x @ cast(p["wdkv"], dtype))   # [B,S,R]
    k_rope = apply_rope((x @ cast(p["wkr"], dtype))[:, :, None, :],
                        pos, rope_theta)                          # [B,S,1,r]
    k_nope = _proj(c_kv, cast(p["wuk"], dtype))
    v = _proj(c_kv, cast(p["wuv"], dtype))

    H = q_nope.shape[2]
    qk_dim = m.qk_nope_dim + m.qk_rope_dim
    pad = padded_qk_dim(qk_dim, m.v_head_dim) - qk_dim
    zeros = q_nope.new_zeros((B, S, H, pad))
    q = torch.cat([q_nope, q_rope, zeros], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(B, S, H, m.qk_rope_dim), zeros],
                  dim=-1)
    o = ops.flash_attention(q, k, v.contiguous(), mask_kind="causal",
                            scale=qk_dim ** -0.5, backend=backend)
    y = o.flatten(-2) @ cast(p["wo"], dtype).flatten(0, 1)
    return y, {"c_kv": c_kv, "k_rope": k_rope[:, :, 0, :]}


def mla_decode(
    p: Dict,
    x: torch.Tensor,                   # [B, D] one token
    cache: Dict,                       # {"c_kv": [B,S,R], "k_rope": [B,S,r]}
    length: torch.Tensor,              # [B] int32 current cache fill
    m: MLAConfig,
    *,
    rope_theta: float,
    dtype=DEFAULT_COMPUTE_DTYPE,
) -> Tuple[torch.Tensor, Dict]:
    """Absorbed-matmul MLA decode on the compressed cache.

    The token's latent and rope key are written into ``cache`` in place
    (the JAX package returns a new cache); the returned dict holds the
    same tensors.
    """
    B = x.shape[0]
    pos = length[:, None]
    q_nope, q_rope = _queries(p, x[:, None, :], m, rope_theta, pos, dtype)
    q_nope, q_rope = q_nope[:, 0], q_rope[:, 0]              # [B,H,*]

    c_t = apply_norm(p["kv_norm"], x @ cast(p["wdkv"], dtype))     # [B,R]
    kr_t = apply_rope((x @ cast(p["wkr"], dtype))[:, None, None, :],
                      pos, rope_theta)[:, 0, 0]                     # [B,r]
    c_cache, r_cache = cache["c_kv"], cache["k_rope"]
    bidx = torch.arange(B, device=x.device)
    slot = length.long()
    c_cache[bidx, slot] = c_t.to(c_cache.dtype)
    r_cache[bidx, slot] = kr_t.to(r_cache.dtype)

    # absorb W_uk into the query: q_lat [B,H,R]
    q_lat = torch.einsum("bhk,rhk->bhr", q_nope, cast(p["wuk"], dtype))
    scale = (m.qk_nope_dim + m.qk_rope_dim) ** -0.5
    logits = (torch.einsum("bhr,bsr->bhs", q_lat, c_cache) +
              torch.einsum("bhk,bsk->bhs", q_rope, r_cache)).float()
    logits = logits * scale
    S = c_cache.shape[1]
    valid = torch.arange(S, device=x.device)[None] < (length + 1)[:, None]
    logits = torch.where(valid[:, None, :], logits,
                         logits.new_full((), -1e30))
    probs = torch.softmax(logits, dim=-1).to(dtype)
    ctx = torch.einsum("bhs,bsr->bhr", probs, c_cache)       # [B,H,R]
    o = torch.einsum("bhr,rhk->bhk", ctx, cast(p["wuv"], dtype))
    y = o.flatten(1) @ cast(p["wo"], dtype).flatten(0, 1)
    return y, cache
