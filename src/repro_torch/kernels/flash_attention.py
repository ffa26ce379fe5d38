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

The launch is the operator ``torch.ops.repro_torch.flash_attention`` (q,
k, v, mask kind, window, q offset, scale, return_lse) -> (out, lse), lse
empty without ``return_lse`` (the kernel then writes none): its CUDA
implementation launches, its fake one allocates the same outputs (the
kernel needs no scratch), its flop formula counts the plain version's
products.  :func:`flash_attention_op` calls it; :func:`flash_attention_cuda`
also refuses tensor subclasses and tensors off the card.
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


def _check(q, k, v, mask_kind: str, real: bool) -> None:
    """Raise on anything the kernel does not take; ``real`` also checks
    what only a tensor with storage has (the device, the alignment)."""
    B, Sq, H, D = q.shape
    if k.dim() != 4 or v.dim() != 4:
        raise ValueError("k and v must be [B, Sk, KV, D]")
    Sk, KV = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if real and t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} must be bfloat16, got {t.dtype}")
        if not t.is_contiguous() or (real and t.data_ptr() % 16):
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


def _outputs(q, v, return_lse: bool):
    B, Sq, H = q.shape[:3]
    out = q.new_empty((B, Sq, H, v.shape[-1]))
    lse = q.new_empty((B, Sq, H), dtype=torch.float32) if return_lse \
        else _build.nothing(q)
    return out, lse


def _launch(q, k, v, mask_kind: str, window: int, q_offset: int,
            scale: float, return_lse: bool):
    """The op's CUDA implementation: check, allocate, launch."""
    _check(q, k, v, mask_kind, True)
    B, Sq, H, D = q.shape
    Sk, KV, Dv = k.shape[1], k.shape[2], v.shape[-1]
    out, lse = _outputs(q, v, return_lse)
    if B == 0 or Sq == 0 or H == 0:
        return out, lse
    lib = _lib()
    status = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if return_lse else None,
        B, Sq, Sk, H, KV, D, Dv, MASK_KINDS[mask_kind], int(window),
        int(q_offset), float(scale), q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, status, "flash_attention_fwd")
    flash_attention_cuda.launches += 1
    if return_lse and Sk == 0:        # the kernel only zeroed out
        lse.fill_(NO_KEY_LSE)
    return out, lse


def _plain(q, k, v, mask_kind: str, window: int, q_offset: int,
           scale: float, return_lse: bool):
    """The op's CPU implementation: the plain version, laid out as the
    kernel lays its outputs."""
    got = flash_attention_plain(q, k, v, mask_kind=mask_kind, window=window,
                                q_offset=q_offset, scale=scale,
                                return_lse=return_lse)
    out, lse = got if return_lse else (got, _build.nothing(q))
    return out.clone(memory_format=torch.contiguous_format), lse.contiguous()


def _fake(q, k, v, mask_kind: str, window: int, q_offset: int,
          scale: float, return_lse: bool):
    _check(q, k, v, mask_kind, False)
    return _outputs(q, v, return_lse)


def flops(q_shape, k_shape, v_shape, mask_kind, window, q_offset, scale,
          return_lse, out_shape=None) -> int:
    """The plain version's products, whole: QK^T over every key and PV
    (the kernel skips masked tiles), and with the lse the plain version's
    second QK^T (the kernel takes the lse from its one pass), so that a
    trace of either backend counts the same."""
    B, Sq, H, D = q_shape
    Sk, Dv = k_shape[1], v_shape[-1]
    return 2 * B * H * Sq * Sk * (D + Dv + (D if return_lse else 0))


OP = _build.define_op(
    "flash_attention",
    "(Tensor q, Tensor k, Tensor v, str mask_kind, int window, "
    "int q_offset, float scale, bool return_lse) -> (Tensor, Tensor)",
    cuda=_launch, cpu=_plain, fake=_fake, flops=flops)


def flash_attention_op(q, k, v, *, mask_kind: str = "causal",
                       window: int = 0, q_offset: int = 0,
                       scale: Optional[float] = None,
                       return_lse: bool = False):
    """The op on ``q, k, v``: the kernel for CUDA tensors, the fake
    implementation for fake ones.  Returns what
    :func:`flash_attention_cuda` returns."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    out, lse = OP(q, k, v, mask_kind, int(window), int(q_offset),
                  float(scale), return_lse)
    return (out, lse) if return_lse else out


def flash_attention_cuda(q, k, v, *, mask_kind: str = "causal",
                         window: int = 0, q_offset: int = 0,
                         scale: Optional[float] = None,
                         return_lse: bool = False):
    """Launch the CUDA kernel.  Returns ``[B, Sq, H, Dv]`` bf16; with
    ``return_lse``, ``(out, lse)`` with lse fp32 ``[B, Sq, H]``.  The
    kernel writes ``out`` the same way either way."""
    _build.check_plain("flash_attention_cuda", q, k, v)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    return flash_attention_op(q, k, v, mask_kind=mask_kind, window=window,
                              q_offset=q_offset, scale=scale,
                              return_lse=return_lse)


#: Launches of the CUDA kernel since the last reset (``launches = 0``).
flash_attention_cuda.launches = 0
