"""Flash attention (prefill): the CUDA kernel's wrapper and its plain version.

The kernel (``csrc/flash_attention.cu``) replaces the Pallas TPU kernel
``repro.kernels.flash_attention.flash_attention_pallas``.  Its wrapper takes
bf16 CUDA tensors in the JAX package's layout (q ``[B, Sq, H, D]``, k
``[B, Sk, KV, D]``, v ``[B, Sk, KV, Dv]``), checks them, allocates the
output and launches on PyTorch's current stream.  It raises on anything the
kernel does not take; it never falls back to the plain version.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import _build, ref

MASK_KINDS = {"none": 0, "causal": 1, "window": 2}
#: (D, Dv) pairs the kernel is built for.
HEAD_DIMS = ((64, 64), (128, 128), (64, 128), (128, 64), (192, 128),
             (256, 256))


def flash_attention_plain(q, k, v, *, mask_kind: str = "causal",
                          window: int = 0, q_offset: int = 0,
                          scale: Optional[float] = None) -> torch.Tensor:
    """The same function through :func:`ref.attention` (float32, quadratic)."""
    Sq, Sk = q.shape[1], k.shape[1]
    if mask_kind == "causal":
        mask = ref.causal_mask(Sq, Sk, q_offset, q.device)
    elif mask_kind == "window":
        mask = ref.window_mask(Sq, Sk, q_offset, window, q.device)
    elif mask_kind == "none":
        mask = None
    else:
        raise ValueError(f"unknown mask_kind {mask_kind!r}")
    return ref.attention(q, k, v, mask, scale)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_fwd.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i,
                                        i, i, ctypes.c_float, i, p]
    lib.flash_attention_fwd.restype = ctypes.c_int
    return lib


def flash_attention_cuda(q, k, v, *, mask_kind: str = "causal",
                         window: int = 0, q_offset: int = 0,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Launch the CUDA kernel.  Returns ``[B, Sq, H, Dv]`` bf16."""
    B, Sq, H, D = q.shape
    if k.dim() != 4 or v.dim() != 4:
        raise ValueError("k and v must be [B, Sk, KV, D]")
    Sk, KV = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} must be bfloat16, got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be on one device")
    if k.shape[0] != B or tuple(v.shape[:3]) != (B, Sk, KV) \
            or k.shape[3] != D:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if H % KV:
        raise ValueError(f"n_heads {H} is not a multiple of n_kv {KV}")
    if (D, Dv) not in HEAD_DIMS:
        raise ValueError(f"head dims D={D}, Dv={Dv} not supported "
                         f"(kernel is built for {HEAD_DIMS})")
    if mask_kind not in MASK_KINDS:
        raise ValueError(f"unknown mask_kind {mask_kind!r}")
    scale = scale if scale is not None else D ** -0.5
    out = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=q.device)
    if B == 0 or Sq == 0 or H == 0:
        return out
    lib = _lib()
    status = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, Sq, Sk, H, KV, D, Dv, MASK_KINDS[mask_kind], int(window),
        int(q_offset), float(scale), q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, status, "flash_attention_fwd")
    flash_attention_cuda.launches += 1
    return out


#: Launches of the CUDA kernel since the last reset (``launches = 0``).
flash_attention_cuda.launches = 0
