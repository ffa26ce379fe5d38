"""Flash attention (prefill, and the forward of training): the CUDA kernel's
wrapper and its plain version.

The kernel (``csrc/flash_attention.cu``) replaces the Pallas TPU kernel
``repro.kernels.flash_attention.flash_attention_pallas``.  Its wrapper takes
bf16 CUDA tensors in the JAX package's layout (q ``[B, Sq, H, D]``, k
``[B, Sk, KV, D]``, v ``[B, Sk, KV, Dv]``), checks them, allocates the
output and launches on PyTorch's current stream.  It raises on anything the
kernel does not take; it never falls back to the plain version.

With ``return_lse=True`` both versions also return the logsumexp that the
backward (:mod:`.flash_attention_bwd`) recomputes the probabilities from:
fp32 ``[B, Sq, H]``, the natural log of the sum of exponentials of the
scaled logits, as ``repro.kernels.ops._flash_fwd_core`` returns it; a row
that no key may attend to gets :data:`NO_KEY_LSE`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import _build, ref

MASK_KINDS = {"none": 0, "causal": 1, "window": 2}
#: (D, Dv) pairs the kernel is built for.  The reduced configs' (32, 32)
#: and (64, 32) (reduced MLA, qk 48 padded to 64) run on the tiles of
#: (64, 64): their tensor maps read the columns past 32 as zeros.
HEAD_DIMS = ((64, 64), (128, 128), (64, 128), (128, 64), (192, 128),
             (256, 256), (32, 32), (64, 32))
#: lse of a row that sees no key: the reference's -1e30 + log(1e-30), which
#: is -1e30 in float32.
NO_KEY_LSE = -1e30


def mask_for(mask_kind: str, Sq: int, Sk: int, window: int, q_offset: int,
             device) -> Optional[torch.Tensor]:
    """The ``[Sq, Sk]`` bool mask (True = attend) of a mask kind, or None."""
    if mask_kind == "causal":
        return ref.causal_mask(Sq, Sk, q_offset, device)
    if mask_kind == "window":
        return ref.window_mask(Sq, Sk, q_offset, window, device)
    if mask_kind == "none":
        return None
    raise ValueError(f"unknown mask_kind {mask_kind!r}")


def flash_attention_plain(q, k, v, *, mask_kind: str = "causal",
                          window: int = 0, q_offset: int = 0,
                          scale: Optional[float] = None,
                          return_lse: bool = False):
    """The same function through :func:`ref.attention` (float32, quadratic);
    with ``return_lse``, ``(out, lse)``."""
    mask = mask_for(mask_kind, q.shape[1], k.shape[1], window, q_offset,
                    q.device)
    out = ref.attention(q, k, v, mask, scale)
    if not return_lse:
        return out
    B, Sq, H, D = q.shape
    KV = k.shape[2]
    scale = scale if scale is not None else D ** -0.5
    logits = torch.einsum("bqhgd,bkhd->bqhgk",
                          q.float().reshape(B, Sq, KV, H // KV, D),
                          k.float()) * scale
    if mask is not None:
        logits = logits.masked_fill(~mask[None, :, None, None, :],
                                    float("-inf"))
    lse = torch.logsumexp(logits, dim=-1).reshape(B, Sq, H)
    return out, lse.masked_fill(torch.isneginf(lse), NO_KEY_LSE)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_fwd.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i,
                                        i, i, i, ctypes.c_float, i, p]
    lib.flash_attention_fwd.restype = ctypes.c_int
    return lib


def flash_attention_cuda(q, k, v, *, mask_kind: str = "causal",
                         window: int = 0, q_offset: int = 0,
                         scale: Optional[float] = None,
                         return_lse: bool = False):
    """Launch the CUDA kernel.  Returns ``[B, Sq, H, Dv]`` bf16; with
    ``return_lse``, ``(out, lse)`` with lse fp32 ``[B, Sq, H]``.  The
    kernel writes ``out`` the same way either way."""
    _build.check_plain("flash_attention_cuda", q, k, v)
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
    lse = torch.empty((B, Sq, H), dtype=torch.float32, device=q.device) \
        if return_lse else None
    if B == 0 or Sq == 0 or H == 0:
        return (out, lse) if return_lse else out
    lib = _lib()
    status = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if return_lse else None,
        B, Sq, Sk, H, KV, D, Dv, MASK_KINDS[mask_kind], int(window),
        int(q_offset), float(scale), q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, status, "flash_attention_fwd")
    flash_attention_cuda.launches += 1
    if not return_lse:
        return out
    if Sk == 0:                       # the kernel only zeroed out
        lse.fill_(NO_KEY_LSE)
    return out, lse


#: Launches of the CUDA kernel since the last reset (``launches = 0``).
flash_attention_cuda.launches = 0
