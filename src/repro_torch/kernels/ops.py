"""Ops used by the model, with the JAX package's signatures
(``repro.kernels.ops``: ``flash_attention``, ``decode_attention``, ``ssd``,
``ssd_decode_step``, ``rglru``, ``rglru_decode_step``, ``moe_dispatch``,
``moe_combine``, ``moe_apply``).

``backend="kernel"`` (the default) routes by where the tensors lie: a CUDA
tensor goes to the hand-written CUDA kernel, which launches or raises; a
CPU tensor goes to the kernel's plain version.  ``backend="ref"`` asks for
the plain version on any device, as ``backend="ref"`` does in the JAX
package; comparisons with the kernels use it.  The single-token decode
steps and the MoE dispatch are plain tensor code, as in the JAX package
(which leaves the MoE's sort, scatter and products to XLA).

Under autograd (grad enabled and an input that requires grad),
:func:`flash_attention` goes through :class:`FlashAttention`, the
counterpart of the JAX package's ``custom_vjp``: the forward saves its
output and logsumexp, and the backward recomputes the probabilities from
them, through the CUDA backward kernel on the card and through its plain
version (the reference formula in float32) otherwise.  :func:`ssd` goes
through :class:`SSDScan` (the JAX package differentiates its XLA scan):
the forward saves its inputs, and the backward recomputes the chunk
states, through the CUDA backward kernel on the card and its plain version
otherwise.  :func:`rglru` goes through :class:`RGLRUScan` (the JAX package
differentiates its XLA scan): the forward saves its inputs, and the
backward recomputes the states, through the CUDA backward kernel on the
card and its plain version otherwise.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .decode_attention import decode_attention_cuda, decode_attention_plain
from .flash_attention import flash_attention_cuda, flash_attention_plain
from .flash_attention_bwd import (
    flash_attention_bwd_cuda,
    flash_attention_bwd_plain,
)
from .rglru_scan import rglru_cuda, rglru_plain
from .rglru_scan_bwd import rglru_bwd_cuda, rglru_bwd_plain
from .ssd_scan import ssd_cuda, ssd_plain
from .ssd_scan_bwd import ssd_bwd_cuda, ssd_bwd_plain

BACKENDS = ("kernel", "ref")

#: Every kernel wrapper, by the kernel's name.
KERNELS = {"flash_attention": flash_attention_cuda,
           "flash_attention_bwd": flash_attention_bwd_cuda,
           "decode_attention": decode_attention_cuda,
           "ssd_scan": ssd_cuda,
           "ssd_scan_bwd": ssd_bwd_cuda,
           "rglru_scan": rglru_cuda,
           "rglru_scan_bwd": rglru_bwd_cuda}


def _use_kernel(backend: str, x: torch.Tensor) -> bool:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (expected {BACKENDS})")
    return backend == "kernel" and x.device.type == "cuda"


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in ts)


class FlashAttention(torch.autograd.Function):
    """Flash attention with the backward of ``repro.kernels.ops.
    _flash_custom``: the forward saves q, k, v, its output and the lse; the
    backward recomputes P from the lse.  ``kernel`` picks the CUDA forward
    and backward kernels, else their plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, mask_kind, window, q_offset, scale, kernel):
        fwd = flash_attention_cuda if kernel else flash_attention_plain
        out, lse = fwd(q, k, v, mask_kind=mask_kind, window=window,
                       q_offset=q_offset, scale=scale, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = dict(mask_kind=mask_kind, window=window,
                        q_offset=q_offset, scale=scale)
        ctx.kernel = kernel
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        bwd = flash_attention_bwd_cuda if ctx.kernel \
            else flash_attention_bwd_plain
        dq, dk, dv = bwd(q, k, v, out, dout.contiguous(), lse, **ctx.args)
        return dq, dk, dv, None, None, None, None, None


class SSDScan(torch.autograd.Function):
    """The SSD scan with the backward of XLA's autodiff of
    ``repro.kernels.ops._ssd_chunked_xla``: the forward saves its inputs;
    the backward recomputes the chunk states.  ``kernel`` picks the CUDA
    forward and backward kernels, else their plain versions.  A final
    state that nothing uses has no cotangent (zeros), and without an
    initial state none is returned."""

    @staticmethod
    def forward(ctx, x, dt, A, Bmat, Cmat, initial_state, chunk, kernel):
        fwd = ssd_cuda if kernel else ssd_plain
        y, state = fwd(x, dt, A, Bmat, Cmat, chunk=chunk,
                       initial_state=initial_state)
        ctx.save_for_backward(x, dt, A, Bmat, Cmat, initial_state)
        ctx.chunk, ctx.kernel = chunk, kernel
        ctx.set_materialize_grads(False)
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        x, dt, A, Bmat, Cmat, h0 = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        bwd = ssd_bwd_cuda if ctx.kernel else ssd_bwd_plain
        grads = bwd(x, dt, A, Bmat, Cmat, dy.contiguous(),
                    None if dstate is None else dstate.contiguous(),
                    chunk=ctx.chunk, initial_state=h0)
        return (*grads, None, None)


class RGLRUScan(torch.autograd.Function):
    """The RG-LRU scan with the backward of XLA's autodiff of
    ``repro.kernels.ops.rglru``: the forward saves its inputs and, on the
    kernel path, the fp32 state entering each chunk (the plain path saves
    None there); the backward recomputes the states from them.
    ``kernel`` picks the CUDA forward and backward kernels, else their
    plain versions.  A final state that nothing uses has no cotangent,
    and without an initial state none is returned."""

    @staticmethod
    def forward(ctx, x, gate_a, gate_i, log_a, initial_state, c, kernel):
        entering = None
        if kernel:
            h, state, entering = rglru_cuda(
                x, gate_a, gate_i, log_a, initial_state=initial_state, c=c,
                entering=True)
        else:
            h, state = rglru_plain(x, gate_a, gate_i, log_a,
                                   initial_state=initial_state, c=c)
        ctx.save_for_backward(x, gate_a, gate_i, log_a, initial_state,
                              entering)
        ctx.c, ctx.kernel = c, kernel
        ctx.set_materialize_grads(False)
        return h, state

    @staticmethod
    def backward(ctx, dh, dstate):
        x, gate_a, gate_i, log_a, h0, entering = ctx.saved_tensors
        if dh is None:
            dh = torch.zeros_like(x)
        args = (x, gate_a, gate_i, log_a, dh.contiguous(),
                None if dstate is None else dstate.contiguous())
        if ctx.kernel:
            grads = rglru_bwd_cuda(*args, entering=entering,
                                   initial_state=h0, c=ctx.c)
        else:
            grads = rglru_bwd_plain(*args, initial_state=h0, c=ctx.c)
        return (*grads, None, None)


def flash_attention(
    q: torch.Tensor,          # [B, Sq, H, D]
    k: torch.Tensor,          # [B, Sk, KV, D]
    v: torch.Tensor,          # [B, Sk, KV, Dv]
    *,
    mask_kind: str = "causal",        # causal|window|none
    window: int = 0,
    q_offset: int = 0,
    scale: Optional[float] = None,
    backend: str = "kernel",
) -> torch.Tensor:
    """Masked GQA attention.  Returns [B, Sq, H, Dv]."""
    kernel = _use_kernel(backend, q)
    if _needs_grad(q, k, v):
        scale = scale if scale is not None else q.shape[-1] ** -0.5
        return FlashAttention.apply(q, k, v, mask_kind, window, q_offset,
                                    scale, kernel)
    fn = flash_attention_cuda if kernel else flash_attention_plain
    return fn(q, k, v, mask_kind=mask_kind, window=window, q_offset=q_offset,
              scale=scale)


def decode_attention(
    q: torch.Tensor,          # [B, H, D]
    k_cache: torch.Tensor,    # [B, S, KV, D]
    v_cache: torch.Tensor,    # [B, S, KV, Dv]
    length: torch.Tensor,     # [B] int32
    *,
    scale: Optional[float] = None,
    backend: str = "kernel",
) -> torch.Tensor:
    """Single-token attention against a padded KV cache.  [B, H, Dv]."""
    fn = decode_attention_cuda if _use_kernel(backend, q) \
        else decode_attention_plain
    return fn(q, k_cache, v_cache, length, scale=scale)


def ssd(
    x: torch.Tensor,          # [B, S, H, P]
    dt: torch.Tensor,         # [B, S, H]
    A: torch.Tensor,          # [H]
    Bmat: torch.Tensor,       # [B, S, G, N]
    Cmat: torch.Tensor,       # [B, S, G, N]
    *,
    chunk: int = 128,
    initial_state: Optional[torch.Tensor] = None,
    backend: str = "kernel",
) -> tuple:
    """Mamba-2 SSD (state-space duality) mixer: (y, final_state)."""
    kernel = _use_kernel(backend, x)
    if _needs_grad(x, dt, A, Bmat, Cmat, initial_state):
        return SSDScan.apply(x, dt, A, Bmat, Cmat, initial_state, chunk,
                             kernel)
    fn = ssd_cuda if kernel else ssd_plain
    return fn(x, dt, A, Bmat, Cmat, chunk=chunk, initial_state=initial_state)


def ssd_decode_step(
    x: torch.Tensor,          # [B, H, P]
    dt: torch.Tensor,         # [B, H]
    A: torch.Tensor,          # [H]
    Bvec: torch.Tensor,       # [B, G, N]
    Cvec: torch.Tensor,       # [B, G, N]
    state: torch.Tensor,      # [B, H, P, N]
) -> tuple:
    """Single-token SSD update: (y [B,H,P], new_state)."""
    rep = x.shape[1] // Bvec.shape[1]
    Bh = Bvec.float().repeat_interleave(rep, dim=1)
    Ch = Cvec.float().repeat_interleave(rep, dim=1)
    dtf = dt.float()
    decay = torch.exp(A.float()[None] * dtf)             # [B,H]
    new_state = state * decay[..., None, None] + \
        (dtf[..., None] * x.float())[..., None] * Bh[:, :, None, :]
    y = torch.einsum("bhpn,bhn->bhp", new_state, Ch)
    return y.to(x.dtype), new_state


def rglru(
    x: torch.Tensor,          # [B, S, C]
    gate_a: torch.Tensor,     # [B, S, C]
    gate_i: torch.Tensor,     # [B, S, C]
    log_a: torch.Tensor,      # [C]
    *,
    initial_state: Optional[torch.Tensor] = None,
    c: float = 8.0,
    backend: str = "kernel",
) -> tuple:
    """RG-LRU linear recurrence: (h [B,S,C], final_state [B,C])."""
    kernel = _use_kernel(backend, x)
    if _needs_grad(x, gate_a, gate_i, log_a, initial_state):
        return RGLRUScan.apply(x, gate_a, gate_i, log_a, initial_state, c,
                               kernel)
    fn = rglru_cuda if kernel else rglru_plain
    return fn(x, gate_a, gate_i, log_a, initial_state=initial_state, c=c)


def rglru_decode_step(x, gate_a, gate_i, log_a, state, c: float = 8.0):
    """Single-token RG-LRU update: inputs [B, C], state [B, C]."""
    log_at = c * log_a.float()[None] * gate_a.float()
    at = torch.exp(log_at)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_at), min=0.0))
    h = at * state + beta * (gate_i.float() * x.float())
    return h.to(x.dtype), h


# ===================================================================== MoE
# The JAX package dispatches one batch row at a time (``jax.vmap`` over
# ``ops.moe_apply``), so capacity is per (row, expert).  Here every function
# takes the rows as a leading axis and is written without a loop over them.
def moe_dispatch(
    x: torch.Tensor,          # [B, T, D]
    topk_idx: torch.Tensor,   # [B, T, K] int64
    topk_gate: torch.Tensor,  # [B, T, K]
    n_experts: int,
    capacity: int,
) -> tuple:
    """Sort each row's tokens into per-expert capacity buffers.

    Returns (buf [B, E, C, D], meta) where meta lets :func:`moe_combine`
    bring expert outputs back to token order.  As in the JAX package, the
    (token, rank) entries of a row are sorted by expert with a stable sort,
    so within an expert they keep token-major, rank-minor order, and an
    entry past its expert's ``capacity`` is dropped.  Each buffer slot is
    gathered from the entry that fills it (no scatter: the result does not
    depend on the order of writes); unfilled slots are zero.
    """
    B, T, D = x.shape
    K = topk_idx.shape[-1]
    TK = T * K
    dev = x.device
    # Each token's ranks in ascending expert order first: within an expert
    # the entries stay in token order (so the same ones are dropped), and
    # meta lists each token's contributions in the order the JAX package's
    # scatter-add visits them.
    topk_idx, by_expert = torch.sort(topk_idx, dim=-1, stable=True)
    topk_gate = topk_gate.gather(-1, by_expert)
    se, order = torch.sort(topk_idx.reshape(B, TK), dim=-1, stable=True)
    experts = torch.arange(n_experts, device=dev).expand(B, n_experts) \
        .contiguous()
    starts = torch.searchsorted(se, experts, side="left")
    counts = torch.searchsorted(se, experts, side="right") - starts
    pos = torch.arange(TK, device=dev) - starts.gather(1, se)
    c = torch.arange(capacity, device=dev)
    src = (starts[..., None] + c).clamp_(max=TK - 1).reshape(B, -1)
    filled = (c < counts[..., None]).reshape(B, -1, 1)
    token = (order // K).gather(1, src)                    # [B, E*C]
    rows = x.gather(1, token[..., None].expand(-1, -1, D))
    buf = torch.where(filled, rows, x.new_zeros(()))
    # meta, in (token, rank) order: the entry's slot (0 when dropped, as the
    # JAX package reads y[0, 0] for it) and its weight (0 when dropped).
    pos = torch.empty_like(pos).scatter_(1, order, pos).view(B, T, K)
    keep = pos < capacity
    slot = torch.where(keep, topk_idx * capacity + pos, 0)
    weight = (topk_gate * keep).to(x.dtype)
    return buf.view(B, n_experts, capacity, D), (slot, weight)


def moe_combine(y: torch.Tensor, meta) -> torch.Tensor:
    """Inverse of :func:`moe_dispatch`: ``y`` [B, E, C, D] weighted back to
    [B, T, D].  Each token's K contributions are summed one after another
    in ascending expert order, rounding to ``y``'s dtype after each add as
    the JAX package's scatter-add does; no atomics, so the result is the
    same on every run and device."""
    slot, weight = meta
    B, T, K = slot.shape
    D = y.shape[-1]
    got = y.reshape(B, -1, D).gather(
        1, slot.reshape(B, -1, 1).expand(-1, -1, D)).view(B, T, K, D)
    contrib = got * weight[..., None]
    out = contrib[:, :, 0]
    for k in range(1, K):
        out = out + contrib[:, :, k]
    return out


def moe_apply(
    x: torch.Tensor,          # [B, T, D]
    gate_w: torch.Tensor,     # [E, D, F]
    up_w: torch.Tensor,       # [E, D, F]
    down_w: torch.Tensor,     # [E, F, D]
    topk_idx: torch.Tensor,   # [B, T, K] int64
    topk_gate: torch.Tensor,  # [B, T, K]
    capacity: int,
    *,
    dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Capacity-based sort-dispatch MoE with SwiGLU experts, each row of
    the batch dispatched on its own.  The expert products run for every
    row at once: one batched matrix product per expert weight."""
    B, T, D = x.shape
    E = gate_w.shape[0]
    buf, meta = moe_dispatch(x, topk_idx, topk_gate, E, capacity)
    be = buf.transpose(0, 1).reshape(E, B * capacity, D)
    h = torch.bmm(be, gate_w.to(dtype))
    u = torch.bmm(be, up_w.to(dtype))
    h = F.silu(h.float()).to(dtype) * u
    y = torch.bmm(h, down_w.to(dtype))                     # [E, B*C, D]
    y = y.view(E, B, capacity, D).transpose(0, 1)
    return moe_combine(y, meta).to(x.dtype)


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}
