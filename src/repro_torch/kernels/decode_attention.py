"""Decode attention: the CUDA kernel's wrapper and its plain version.

The kernel (``csrc/decode_attention.cu``) replaces the Pallas TPU kernel
``repro.kernels.decode_attention.decode_attention_pallas``.  Its wrapper
takes bf16 CUDA tensors in the JAX package's layout (q ``[B, H, D]``,
caches ``[B, S, KV, D/Dv]``, ``length`` int32 ``[B]`` on the same device),
allocates the output and the split-K scratch, and launches both passes on
PyTorch's current stream.  ``length`` is never read on the host.  It raises
on anything the kernel does not take; it never falls back.

Both versions return zeros for a row with ``length == 0``, as the Pallas
kernel does (the reference oracle returns NaN there).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import _build, ref


def decode_attention_plain(q, k_cache, v_cache, length, *,
                           scale: Optional[float] = None) -> torch.Tensor:
    """The same function through :func:`ref.decode_attention` (float32)."""
    out = ref.decode_attention(q, k_cache, v_cache, length, scale)
    return torch.where((length > 0)[:, None, None], out, torch.zeros_like(out))


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("decode_attention")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.decode_attention_fwd.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i,
                                         i, i, ctypes.c_float, i, p]
    lib.decode_attention_fwd.restype = ctypes.c_int
    lib.decode_attention_splits.argtypes = [i]
    lib.decode_attention_splits.restype = ctypes.c_int
    return lib


def decode_attention_cuda(q, k_cache, v_cache, length, *,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Launch the CUDA kernel (split-K pass + combine pass).  [B, H, Dv]."""
    if q.dim() != 3 or k_cache.dim() != 4 or v_cache.dim() != 4:
        raise ValueError("q must be [B, H, D] and the caches [B, S, KV, D]")
    B, H, D = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    Dv = v_cache.shape[-1]
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} must be bfloat16, got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 4:
            raise ValueError(f"{name} must be contiguous and 4-byte aligned")
    if length.device != q.device or length.dtype != torch.int32 \
            or tuple(length.shape) != (B,) or not length.is_contiguous():
        raise ValueError("length must be a contiguous int32 [B] tensor on "
                         "the device of q")
    if k_cache.device != q.device or v_cache.device != q.device:
        raise ValueError("q and the caches must be on one device")
    if k_cache.shape[0] != B or k_cache.shape[3] != D \
            or tuple(v_cache.shape[:3]) != (B, S, KV):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k_cache "
                         f"{tuple(k_cache.shape)}, v_cache "
                         f"{tuple(v_cache.shape)}")
    if H % KV or D % 2 or Dv % 2 or S == 0:
        raise ValueError(f"unsupported shape H={H} KV={KV} D={D} Dv={Dv} "
                         f"S={S}")
    scale = scale if scale is not None else D ** -0.5
    out = torch.empty((B, H, Dv), dtype=q.dtype, device=q.device)
    if B == 0:
        return out
    lib = _lib()
    G = H // KV
    n_split = lib.decode_attention_splits(S)
    part_m = torch.empty((B, KV, n_split, G), dtype=torch.float32,
                         device=q.device)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((B, KV, n_split, G, Dv), dtype=torch.float32,
                           device=q.device)
    status = lib.decode_attention_fwd(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        length.data_ptr(), part_m.data_ptr(), part_l.data_ptr(),
        part_acc.data_ptr(), out.data_ptr(), B, S, H, KV, D, Dv,
        float(scale), q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, status, "decode_attention_fwd")
    decode_attention_cuda.launches += 1
    return out


#: Launches of the CUDA kernel since the last reset (``launches = 0``).
decode_attention_cuda.launches = 0
