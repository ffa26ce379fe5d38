"""Decode attention: the CUDA kernel's wrapper and its plain version.

The kernel (``csrc/decode_attention.cu``) replaces the Pallas TPU kernel
``repro.kernels.decode_attention.decode_attention_pallas``.  Its wrapper
takes bf16 CUDA tensors in the JAX package's layout (q ``[B, H, D]``,
caches ``[B, S, KV, D/Dv]``, ``length`` int32 ``[B]`` on the same device),
allocates the output and one fp32 scratch tensor for the split partials,
and launches the kernel once on PyTorch's current stream.  ``length`` is
never read on the host: :func:`plan` picks the number of splits from the
shapes alone, and the kernel shares each row's filled keys over them.  The
kernel's last CTA per (batch, KV head) is found with an int32 counter that
every call leaves at zero; the wrapper keeps one such tensor per device
(:func:`counters`), grown when ``B * KV`` grows.  It raises on anything the
kernel does not take; it never falls back.

Both versions return zeros for a row with ``length == 0``, as the Pallas
kernel does (the reference oracle returns NaN there).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from . import _build, ref

#: (D, Dv) pairs the kernel is built for; (32, 32) is the reduced configs'.
HEAD_DIMS = ((64, 64), (128, 128), (64, 128), (256, 256), (32, 32))
#: K and V bytes one CTA holds in shared memory at once.
KV_SMEM = 64 * 1024
#: Fewest keys a split takes when the cache is short: fewer would make the
#: fp32 partials outweigh the K/V bytes they stand for.
MIN_KEYS = 32
#: Dynamic shared memory a CTA may ask for (the card's 227 KB less 1 KB).
MAX_SMEM = 226 * 1024
#: Query heads per KV head the kernel takes (the rows of its mma tiles).
MAX_GROUP = 16
# The kernel's block: 4 warps, keys in steps of 16, bf16 rows of K, V and Q
# padded by 8 elements, fp32 rows of a warp's staged result by 4.
_WARPS, _STEP = 4, 16


def plan(S: int, D: int, Dv: int, G: int, bkv: int,
         n_sm: int) -> Tuple[int, int]:
    """``(n_split, shared memory bytes)`` for a launch on ``n_sm`` SMs.

    Enough splits that a split's K and V (at most ``ceil(S / n_split)``
    keys) fit in ``KV_SMEM``; at least ``n_sm`` CTAs over ``bkv`` (batch x
    KV heads) where the cache holds ``MIN_KEYS`` keys per split; never more
    splits than keys.  (On the device a split takes at least as many keys
    as keep its fp32 partial at 1/8 of its K/V bytes, so splits past a
    short length only arrive.)  The bytes mirror ``smem_bytes`` in the CUDA
    source.
    """
    cap = KV_SMEM // (2 * (D + Dv))
    need = -(-S // cap)
    fill = min(-(-n_sm // bkv), -(-S // MIN_KEYS))
    n_split = min(S, max(need, fill))
    keys = -(-S // n_split)
    keys = -(-keys // _STEP) * _STEP
    smem = 16 + 2 * (keys * (D + Dv + 16) + MAX_GROUP * (D + 8)) + 4 * (
        _WARPS * MAX_GROUP * (Dv + 4) + 2 * G * n_split + G)
    return n_split, smem


def decode_attention_plain(q, k_cache, v_cache, length, *,
                           scale: Optional[float] = None) -> torch.Tensor:
    """The same function through :func:`ref.decode_attention` (float32)."""
    out = ref.decode_attention(q, k_cache, v_cache, length, scale)
    return torch.where((length > 0)[:, None, None], out, torch.zeros_like(out))


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("decode_attention")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.decode_attention_fwd.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i,
                                         i, i, ctypes.c_float, i, p]
    lib.decode_attention_fwd.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_COUNTERS: Dict[int, torch.Tensor] = {}


def counters(device: torch.device, n: int = 0) -> torch.Tensor:
    """The zeroed int32 counters the kernel uses on ``device``, at least
    ``n`` of them.  Every launch leaves them at zero; all launches run on
    one stream, so no two calls share them at once."""
    t = _COUNTERS.get(device.index)
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 64), dtype=torch.int32, device=device)
        _COUNTERS[device.index] = t
    return t


def decode_attention_cuda(q, k_cache, v_cache, length, *,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Launch the CUDA kernel (split-K with an in-kernel combine). [B, H, Dv]."""
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
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
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
    if H % KV or H // KV > MAX_GROUP or (D, Dv) not in HEAD_DIMS or S == 0:
        raise ValueError(f"unsupported shape H={H} KV={KV} S={S} head dims "
                         f"(D, Dv)=({D}, {Dv}); the kernel takes {HEAD_DIMS} "
                         f"and at most {MAX_GROUP} query heads per KV head")
    scale = scale if scale is not None else D ** -0.5
    out = torch.empty((B, H, Dv), dtype=q.dtype, device=q.device)
    if B == 0:
        return out
    G = H // KV
    n_split, smem = plan(S, D, Dv, G, B * KV, _sm_count(q.device.index))
    if smem > MAX_SMEM:
        raise ValueError(f"S={S} needs {smem} bytes of shared memory per "
                         f"CTA, more than {MAX_SMEM}")
    lib = _lib()
    part = torch.empty(B * KV * n_split * G * (Dv + 2), dtype=torch.float32,
                       device=q.device)
    status = lib.decode_attention_fwd(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        length.data_ptr(), part.data_ptr(),
        counters(q.device, B * KV).data_ptr(), out.data_ptr(), B, S, H, KV,
        D, Dv, n_split, float(scale), q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, status, "decode_attention_fwd")
    decode_attention_cuda.launches += 1
    return out


#: Launches of the CUDA kernel since the last reset (``launches = 0``).
decode_attention_cuda.launches = 0
