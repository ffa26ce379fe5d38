"""Plain PyTorch versions of the oracles (``repro.kernels.ref``).

Simple (quadratic attention, sequential scans, every token through every
expert), computed in float32: the semantic ground truth that the kernels'
plain versions and the CUDA kernels are held to.  The attention oracles
are also the path the attention wrappers take for tensors that lie on the
CPU; the MoE oracle is the tests' check of ``ops.moe_apply``.
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


def ssd_scan(
    x: torch.Tensor,          # [B, S, H, P]
    dt: torch.Tensor,         # [B, S, H]        (softplus already applied)
    A: torch.Tensor,          # [H]              (negative)
    Bmat: torch.Tensor,       # [B, S, G, N]
    Cmat: torch.Tensor,       # [B, S, G, N]
    initial_state: Optional[torch.Tensor] = None,  # [B, H, P, N]
) -> tuple:
    """Mamba-2 SSD recurrence, sequential reference.

    h_t = exp(A dt_t) * h_{t-1} + dt_t * x_t B_t^T    (outer product P x N)
    y_t = h_t C_t
    Returns (y [B,S,H,P], final_state [B,H,P,N]).
    """
    Bsz, S, H, P = x.shape
    G, N = Bmat.shape[2], Bmat.shape[3]
    rep = H // G
    xf, dtf, Af = x.float(), dt.float(), A.float()
    Bf = Bmat.float().repeat_interleave(rep, dim=2)          # [B,S,H,N]
    Cf = Cmat.float().repeat_interleave(rep, dim=2)
    h = (initial_state.float() if initial_state is not None
         else torch.zeros((Bsz, H, P, N), device=x.device))
    ys = []
    for t in range(S):
        decay = torch.exp(Af[None] * dtf[:, t])              # [B,H]
        h = h * decay[..., None, None] + \
            (dtf[:, t, :, None] * xf[:, t])[..., None] * Bf[:, t, :, None, :]
        ys.append(torch.einsum("bhpn,bhn->bhp", h, Cf[:, t]))
    y = torch.stack(ys, dim=1) if ys else xf.new_zeros((Bsz, 0, H, P))
    return y.to(x.dtype), h


def rglru_scan(
    x: torch.Tensor,          # [B, S, C] gated input
    gate_a: torch.Tensor,     # [B, S, C] recurrence gate in (0,1)
    gate_i: torch.Tensor,     # [B, S, C] input gate in (0,1)
    log_a: torch.Tensor,      # [C] per-channel base decay (log, negative)
    initial_state: Optional[torch.Tensor] = None,  # [B, C]
    c: float = 8.0,
) -> tuple:
    """RG-LRU recurrence (RecurrentGemma), sequential reference.

    a_t = exp(c * log_a * r_t);  h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t x_t)
    Returns (h [B,S,C], final_state [B,C]).
    """
    Bsz, S, C = x.shape
    xf, rf, inf_ = x.float(), gate_a.float(), gate_i.float()
    la = log_a.float()
    h = (initial_state.float() if initial_state is not None
         else torch.zeros((Bsz, C), device=x.device))
    hs = []
    for t in range(S):
        log_at = c * la[None] * rf[:, t]                     # [B,C], <= 0
        at = torch.exp(log_at)
        beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_at), min=0.0))
        h = at * h + beta * (inf_[:, t] * xf[:, t])
        hs.append(h)
    out = torch.stack(hs, dim=1) if hs else xf.new_zeros((Bsz, 0, C))
    return out.to(x.dtype), h


def moe_dense(
    x: torch.Tensor,          # [T, D] tokens
    gate_w: torch.Tensor,     # [E, D, F]
    up_w: torch.Tensor,       # [E, D, F]
    down_w: torch.Tensor,     # [E, F, D]
    probs: torch.Tensor,      # [T, E] routing weights (0 where unrouted)
) -> torch.Tensor:
    """Dense-einsum MoE oracle: every token through every expert, weighted.

    O(T*E*D*F) -- only usable at test sizes; the efficient path uses
    capacity-based dispatch (``ops.moe_apply``).
    """
    xf = x.float()
    h = torch.einsum("td,edf->tef", xf, gate_w.float())
    u = torch.einsum("td,edf->tef", xf, up_w.float())
    h = torch.nn.functional.silu(h) * u
    y = torch.einsum("tef,efd->ted", h, down_w.float())
    return torch.einsum("ted,te->td", y, probs.float()).to(x.dtype)
