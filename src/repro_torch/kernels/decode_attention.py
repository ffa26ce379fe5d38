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
(:func:`counters`), grown when ``B * KV`` grows, and a CUDA graph that
captured a launch keeps the tensor it baked in.  It raises on anything the
kernel does not take; it never falls back.

Both versions return zeros for a row with ``length == 0``, as the Pallas
kernel does (the reference oracle returns NaN there).  With
``return_lse`` both also return each head's logsumexp, fp32 ``[B, H]``,
-inf for a row of length 0: the sharded decode combines the slices of a
sequence-sharded cache by it (:mod:`repro_torch.sharding.calls`).  The
kernel writes it from the combine's running max and sum; ``out`` is the
same with it or without.

The launch is the operator ``torch.ops.repro_torch.decode_attention`` (q,
k_cache, v_cache, length, scale, return_lse) -> (out, lse), lse empty
without ``return_lse``: its CUDA implementation launches, its fake one
allocates the outputs and the split partials, planned for
``_build.H100_SMS`` SMs (the counters live outside any call), its flop
formula counts the plain version's products.  :func:`decode_attention_op`
calls it; :func:`decode_attention_cuda` also refuses tensor subclasses and
tensors off the card.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from .. import graphs
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
                           scale: Optional[float] = None,
                           return_lse: bool = False):
    """The same function through :func:`ref.decode_attention` (float32)."""
    out = ref.decode_attention(q, k_cache, v_cache, length, scale)
    out = torch.where((length > 0)[:, None, None], out, torch.zeros_like(out))
    if not return_lse:
        return out
    B, H, D = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    scale = scale if scale is not None else D ** -0.5
    logits = torch.einsum("bhgd,bshd->bhgs",
                          q.float().reshape(B, KV, H // KV, D),
                          k_cache.float()) * scale
    valid = torch.arange(S, device=q.device)[None] < length[:, None]
    logits = logits.masked_fill(~valid[:, None, None], float("-inf"))
    return out, torch.logsumexp(logits, dim=-1).reshape(B, H)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("decode_attention")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.decode_attention_fwd.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i,
                                         i, i, i, ctypes.c_float, i, p]
    lib.decode_attention_fwd.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_COUNTERS: Dict[int, torch.Tensor] = {}


def counters(device: torch.device, n: int = 0) -> torch.Tensor:
    """The zeroed int32 counters the kernel uses on ``device``, at least
    ``n`` of them.  Every launch leaves them at zero and launches run one
    at a time (one stream, or a graph's capture stream waited for), so no
    two calls share them at once.  A larger ``n`` replaces the tensor; a
    CUDA graph keeps the one its launches baked in (:func:`graphs.hold`),
    so the tensor may not grow while a graph is being captured."""
    t = _COUNTERS.get(device.index)
    if t is None or t.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "decode_attention: the counters would grow inside a CUDA "
                "graph capture; launch the step eagerly first")
        t = torch.zeros(max(n, 64), dtype=torch.int32, device=device)
        _COUNTERS[device.index] = t
    return t


def _check(q, k_cache, v_cache, length, real: bool) -> None:
    """Raise on anything the kernel does not take; ``real`` also checks
    what only a tensor with storage has (the device, the alignment)."""
    if q.dim() != 3 or k_cache.dim() != 4 or v_cache.dim() != 4:
        raise ValueError("q must be [B, H, D] and the caches [B, S, KV, D]")
    B, H, D = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    Dv = v_cache.shape[-1]
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if real and t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} must be bfloat16, got {t.dtype}")
        if not t.is_contiguous() or (real and t.data_ptr() % 16):
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


def _allocate(q, k_cache, v_cache, return_lse: bool, n_sm: int):
    """``(out, lse, part, n_split)``: the outputs and the split partials
    of a launch on ``n_sm`` SMs (``part`` None when B is 0)."""
    B, H, D = q.shape
    S, KV, Dv = k_cache.shape[1], k_cache.shape[2], v_cache.shape[-1]
    out = q.new_empty((B, H, Dv))
    lse = q.new_empty((B, H), dtype=torch.float32) if return_lse \
        else _build.nothing(q)
    if B == 0:
        return out, lse, None, 0
    G = H // KV
    n_split, smem = plan(S, D, Dv, G, B * KV, n_sm)
    if smem > MAX_SMEM:
        raise ValueError(f"S={S} needs {smem} bytes of shared memory per "
                         f"CTA, more than {MAX_SMEM}")
    part = q.new_empty((B * KV * n_split * G * (Dv + 2),),
                       dtype=torch.float32)
    return out, lse, part, n_split


def _launch(q, k_cache, v_cache, length, scale: float, return_lse: bool):
    """The op's CUDA implementation: check, allocate, launch."""
    _check(q, k_cache, v_cache, length, True)
    out, lse, part, n_split = _allocate(q, k_cache, v_cache, return_lse,
                                        _sm_count(q.device.index))
    if part is None:
        return out, lse
    B, H, D = q.shape
    S, KV, Dv = k_cache.shape[1], k_cache.shape[2], v_cache.shape[-1]
    lib = _lib()
    count = counters(q.device, B * KV)
    graphs.hold(count)
    status = lib.decode_attention_fwd(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        length.data_ptr(), part.data_ptr(), count.data_ptr(), out.data_ptr(),
        lse.data_ptr() if return_lse else None, B, S, H, KV,
        D, Dv, n_split, float(scale), q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, status, "decode_attention_fwd")
    graphs.count(decode_attention_cuda)
    return out, lse


def _plain(q, k_cache, v_cache, length, scale: float, return_lse: bool):
    """The op's CPU implementation: the plain version, laid out as the
    kernel lays its outputs."""
    got = decode_attention_plain(q, k_cache, v_cache, length, scale=scale,
                                 return_lse=return_lse)
    out, lse = got if return_lse else (got, _build.nothing(q))
    return out.clone(memory_format=torch.contiguous_format), lse.contiguous()


def _fake(q, k_cache, v_cache, length, scale: float, return_lse: bool):
    _check(q, k_cache, v_cache, length, False)
    out, lse, part, _ = _allocate(q, k_cache, v_cache, return_lse,
                                  _build.H100_SMS)
    _build.fake_scratch(part)
    return out, lse


def flops(q_shape, k_shape, v_shape, length_shape, scale, return_lse,
          out_shape=None) -> int:
    """The plain version's products over every slot of the cache (the
    kernel reads only the filled ones): q.K^T and p.V, and with the lse
    the plain version's second q.K^T."""
    B, H, D = q_shape
    S, Dv = k_shape[1], v_shape[-1]
    return 2 * B * H * S * (D + Dv + (D if return_lse else 0))


OP = _build.define_op(
    "decode_attention",
    "(Tensor q, Tensor k_cache, Tensor v_cache, Tensor length, float scale, "
    "bool return_lse) -> (Tensor, Tensor)",
    cuda=_launch, cpu=_plain, fake=_fake, flops=flops)


def decode_attention_op(q, k_cache, v_cache, length, *,
                        scale: Optional[float] = None,
                        return_lse: bool = False):
    """The op: the kernel for CUDA tensors, the fake implementation for
    fake ones.  Returns what :func:`decode_attention_cuda` returns."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    out, lse = OP(q, k_cache, v_cache, length, float(scale), return_lse)
    return (out, lse) if return_lse else out


def decode_attention_cuda(q, k_cache, v_cache, length, *,
                          scale: Optional[float] = None,
                          return_lse: bool = False):
    """Launch the CUDA kernel (split-K with an in-kernel combine). [B, H, Dv];
    with ``return_lse``, ``(out, lse)``."""
    _build.check_plain("decode_attention_cuda", q, k_cache, v_cache, length)
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    return decode_attention_op(q, k_cache, v_cache, length, scale=scale,
                               return_lse=return_lse)


#: Launches of the CUDA kernel since the last reset (``launches = 0``).
decode_attention_cuda.launches = 0
