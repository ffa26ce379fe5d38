"""Flash attention backward: the CUDA kernel's wrapper and its plain version.

The kernel (``csrc/flash_attention_bwd.cu``) replaces the backward of the
JAX package's ``repro.kernels.ops.flash_attention`` (the XLA
``custom_vjp`` of ``_flash_custom``; no Pallas kernel exists for it).  It
recomputes the probabilities from the forward's logsumexp
(:func:`repro_torch.kernels.flash_attention.flash_attention_cuda` with
``return_lse=True``) and returns ``(dq, dk, dv)``.  Its wrapper takes bf16
CUDA tensors in the JAX package's layout (q ``[B, Sq, H, D]``, k ``[B, Sk,
KV, D]``, v ``[B, Sk, KV, Dv]``, out and dout ``[B, Sq, H, Dv]``) and lse
fp32 ``[B, Sq, H]``, checks them, allocates the gradients and the fp32
``delta`` scratch and launches on PyTorch's current stream.  It raises on
anything the kernel does not take; it never falls back to the plain
version.  One call of the wrapper is one launch of the kernel (its three
CUDA kernels: delta, dK/dV, dQ).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import _build
from .flash_attention import MASK_KINDS, mask_for

#: (D, Dv) pairs the backward is built for: yi-6b's and the 100M example's.
HEAD_DIMS = ((64, 64), (128, 128))


def flash_attention_bwd_plain(q, k, v, out, dout, lse, *,
                              mask_kind: str = "causal", window: int = 0,
                              q_offset: int = 0,
                              scale: Optional[float] = None,
                              dtype: torch.dtype = torch.float32) -> tuple:
    """``repro.kernels.ops``'s backward formula, quadratic (all keys at
    once instead of KV chunks): the products in ``dtype`` (float32: the
    reference's arithmetic; bfloat16: each product's operands rounded to
    bf16, the card's working type), exponentials, delta and dS in float32.
    Returns ``(dq, dk, dv)`` in the dtypes of q, k and v."""
    B, Sq, H, D = q.shape
    KV, Dv = k.shape[2], v.shape[-1]
    G = H // KV
    scale = scale if scale is not None else D ** -0.5
    mask = mask_for(mask_kind, Sq, k.shape[1], window, q_offset, q.device)
    qf = (q.float() * scale).to(dtype).reshape(B, Sq, KV, G, D)
    kf, vf = k.to(dtype), v.to(dtype)
    do = dout.to(dtype).reshape(B, Sq, KV, G, Dv)
    delta = (do.float() * out.float().reshape(B, Sq, KV, G, Dv)).sum(-1)
    logits = torch.einsum("bqhgd,bkhd->bqhgk", qf, kf).float()
    p = torch.exp(logits - lse.float().reshape(B, Sq, KV, G)[..., None])
    if mask is not None:
        p = p.masked_fill(~mask[None, :, None, None, :], 0.0)
    dv = torch.einsum("bqhgk,bqhgd->bkhd", p.to(dtype), do)
    dp = torch.einsum("bqhgd,bkhd->bqhgk", do, vf).float()
    ds = (p * (dp - delta[..., None])).to(dtype)
    dq = torch.einsum("bqhgk,bkhd->bqhgd", ds, kf).float() * scale
    dk = torch.einsum("bqhgk,bqhgd->bkhd", ds, qf)
    return (dq.reshape(B, Sq, H, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention_bwd")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_bwd.argtypes = [p] * 10 + [i] * 10 + [
        ctypes.c_float, i, p]
    lib.flash_attention_bwd.restype = ctypes.c_int
    return lib


def flash_attention_bwd_cuda(q, k, v, out, dout, lse, *,
                             mask_kind: str = "causal", window: int = 0,
                             q_offset: int = 0,
                             scale: Optional[float] = None) -> tuple:
    """Launch the CUDA kernel.  Returns ``(dq, dk, dv)``, bf16."""
    B, Sq, H, D = q.shape
    if k.dim() != 4 or v.dim() != 4:
        raise ValueError("k and v must be [B, Sk, KV, D]")
    Sk, KV, Dv = k.shape[1], k.shape[2], v.shape[-1]
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"q must be a CUDA tensor, got {dev}")
    if (D, Dv) not in HEAD_DIMS:
        raise ValueError(f"head dims D={D}, Dv={Dv} not supported by the "
                         f"backward (built for {HEAD_DIMS})")
    if k.shape[0] != B or k.shape[3] != D or H % max(KV, 1):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    if mask_kind not in MASK_KINDS:
        raise ValueError(f"unknown mask_kind {mask_kind!r}")
    for name, t, shape in (("q", q, (B, Sq, H, D)), ("k", k, (B, Sk, KV, D)),
                           ("v", v, (B, Sk, KV, Dv)),
                           ("out", out, (B, Sq, H, Dv)),
                           ("dout", dout, (B, Sq, H, Dv))):
        _build.check_tensor(name, t, torch.bfloat16, shape, dev)
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    _build.check_tensor("lse", lse, torch.float32, (B, Sq, H), dev)
    scale = scale if scale is not None else D ** -0.5
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if B == 0 or Sq == 0 or Sk == 0 or H == 0:
        # nothing to attend to, or no query to attend: zero gradients
        return dq.zero_(), dk.zero_(), dv.zero_()
    delta = torch.empty((B, Sq, H), dtype=torch.float32, device=dev)
    lib = _lib()
    status = lib.flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), B, Sq, Sk, H, KV, D, Dv,
        MASK_KINDS[mask_kind], int(window), int(q_offset), float(scale),
        dev.index, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, status, "flash_attention_bwd")
    flash_attention_bwd_cuda.launches += 1
    return dq, dk, dv


#: Launches of the CUDA kernel since the last reset (``launches = 0``).
flash_attention_bwd_cuda.launches = 0
