"""Ops used by the model, with the JAX package's signatures
(``repro.kernels.ops``: ``flash_attention``, ``decode_attention``, ``ssd``,
``ssd_decode_step``, ``rglru``, ``rglru_decode_step``).

``backend="kernel"`` (the default) routes by where the tensors lie: a CUDA
tensor goes to the hand-written CUDA kernel, which launches or raises; a
CPU tensor goes to the kernel's plain version.  ``backend="ref"`` asks for
the plain version on any device, as ``backend="ref"`` does in the JAX
package; comparisons with the kernels use it.  The single-token decode
steps are plain tensor code, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch

from .decode_attention import decode_attention_cuda, decode_attention_plain
from .flash_attention import flash_attention_cuda, flash_attention_plain
from .rglru_scan import rglru_cuda, rglru_plain
from .ssd_scan import ssd_cuda, ssd_plain

BACKENDS = ("kernel", "ref")

#: Every kernel wrapper, by the kernel's name.
KERNELS = {"flash_attention": flash_attention_cuda,
           "decode_attention": decode_attention_cuda,
           "ssd_scan": ssd_cuda,
           "rglru_scan": rglru_cuda}


def _use_kernel(backend: str, x: torch.Tensor) -> bool:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (expected {BACKENDS})")
    return backend == "kernel" and x.device.type == "cuda"


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
    fn = flash_attention_cuda if _use_kernel(backend, q) \
        else flash_attention_plain
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
    fn = ssd_cuda if _use_kernel(backend, x) else ssd_plain
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
    fn = rglru_cuda if _use_kernel(backend, x) else rglru_plain
    return fn(x, gate_a, gate_i, log_a, initial_state=initial_state, c=c)


def rglru_decode_step(x, gate_a, gate_i, log_a, state, c: float = 8.0):
    """Single-token RG-LRU update: inputs [B, C], state [B, C]."""
    log_at = c * log_a.float()[None] * gate_a.float()
    at = torch.exp(log_at)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_at), min=0.0))
    h = at * state + beta * (gate_i.float() * x.float())
    return h.to(x.dtype), h


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}
