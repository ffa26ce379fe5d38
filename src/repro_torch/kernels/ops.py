"""Attention ops used by the model, with the JAX package's signatures
(``repro.kernels.ops.flash_attention`` / ``decode_attention``).

``backend="kernel"`` (the default) routes by where the tensors lie: a CUDA
tensor goes to the hand-written CUDA kernel, which launches or raises; a
CPU tensor goes to the kernel's plain version.  ``backend="ref"`` asks for
the plain version on any device, as ``backend="ref"`` does in the JAX
package; comparisons with the kernels use it.
"""

from __future__ import annotations

from typing import Optional

import torch

from .decode_attention import decode_attention_cuda, decode_attention_plain
from .flash_attention import flash_attention_cuda, flash_attention_plain

BACKENDS = ("kernel", "ref")


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


def reset_launch_counts() -> None:
    flash_attention_cuda.launches = 0
    decode_attention_cuda.launches = 0


def launch_counts() -> dict:
    return {"flash_attention": flash_attention_cuda.launches,
            "decode_attention": decode_attention_cuda.launches}
