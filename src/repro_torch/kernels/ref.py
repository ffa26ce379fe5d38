"""Plain PyTorch versions of the attention oracles (``repro.kernels.ref``).

Simple and quadratic, computed in float32: the semantic ground truth that
the CUDA kernels are held to, and the path every kernel wrapper takes for
tensors that lie on the CPU.
"""

from __future__ import annotations

from typing import Optional

import torch


def causal_mask(s_q: int, s_k: int, q_offset: int,
                device=None) -> torch.Tensor:
    """[s_q, s_k] True where query may attend (supports KV-cache offsets)."""
    q_pos = q_offset + torch.arange(s_q, device=device)[:, None]
    k_pos = torch.arange(s_k, device=device)[None, :]
    return k_pos <= q_pos


def window_mask(s_q: int, s_k: int, q_offset: int, window: int,
                device=None) -> torch.Tensor:
    q_pos = q_offset + torch.arange(s_q, device=device)[:, None]
    k_pos = torch.arange(s_k, device=device)[None, :]
    return (k_pos <= q_pos) & (k_pos > q_pos - window)


def attention(
    q: torch.Tensor,          # [B, Sq, H, D]
    k: torch.Tensor,          # [B, Sk, KV, D]
    v: torch.Tensor,          # [B, Sk, KV, Dv]
    mask: Optional[torch.Tensor] = None,   # [Sq, Sk] bool, True = attend
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Exact GQA attention (quadratic).  Returns [B, Sq, H, Dv]."""
    B, Sq, H, D = q.shape
    KV = k.shape[2]
    if H % KV:
        raise ValueError(f"n_heads {H} is not a multiple of n_kv {KV}")
    G = H // KV
    scale = scale if scale is not None else D ** -0.5
    qf = q.float().reshape(B, Sq, KV, G, D)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) * scale
    if mask is not None:
        logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    probs = torch.nan_to_num(probs, nan=0.0)            # fully-masked rows
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    return out.reshape(B, Sq, H, -1).to(q.dtype)


def decode_attention(
    q: torch.Tensor,          # [B, H, D] single query token
    k_cache: torch.Tensor,    # [B, S, KV, D]
    v_cache: torch.Tensor,    # [B, S, KV, Dv]
    length: torch.Tensor,     # [B] valid cache lengths
    scale: Optional[float] = None,
) -> torch.Tensor:
    """One-token attention against a (padded) KV cache.  [B, H, Dv].

    As in the reference oracle, a row with ``length == 0`` has no valid key
    and comes out NaN; the kernels' plain versions zero it.
    """
    B, H, D = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    scale = scale if scale is not None else D ** -0.5
    qf = q.float().reshape(B, KV, G, D)
    logits = torch.einsum("bhgd,bshd->bhgs", qf, k_cache.float()) * scale
    valid = torch.arange(S, device=q.device)[None] < length[:, None]  # [B,S]
    logits = logits.masked_fill(~valid[:, None, None], float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", probs, v_cache.float())
    return out.reshape(B, H, -1).to(q.dtype)
