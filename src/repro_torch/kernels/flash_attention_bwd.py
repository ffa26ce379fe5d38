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
scratch of lse and delta and launches on PyTorch's current stream.  It
raises on anything the kernel does not take; it never falls back to the
plain version.  One call of the wrapper is one launch of the kernel (its
three CUDA kernels: delta, dK/dV, dQ; at the wide pairs with more than
one slice a fourth sums the slices' parts of dK and dV).

:func:`smem_bytes`, :func:`dkdv_steps`, :func:`dq_tiles` and
:func:`dq_tiles_wide` mirror the kernel's shared-memory layouts and the
work each CTA does, so that the CPU tests can hold the schedule to the
mask and the tiled arithmetic to the plain formula.  At the pairs of
``WIDE_PAIRS`` ((256, 256), recurrentgemma-2b's local attention, and
(192, 128), deepseek-v2-lite's MLA) two kernels of their own take the
pair: in the dK/dV kernel both warpgroups work on the same steps
(warpgroup 0 forms S^T over D and P^T and holds dV, 64 x Dv; warpgroup
1 forms dP^T over Dv and dS^T and holds dK, 64 x D) and warpgroup 0
hands P^T over in bf16 behind mbarriers, and each KV group's heads are
taken in :func:`wide_splits` slices (:func:`slice_heads`), whose fp32
parts a fourth CUDA kernel sums (one slice writes the bf16 gradients
itself); in the dQ kernel each warpgroup takes half of every key tile
and holds 64 x D of dQ, and K and V have rings of their own.

The launch is the operator ``torch.ops.repro_torch.flash_attention_bwd``
(q, k, v, out, dout, lse, mask kind, window, q offset, scale) -> (dq, dk,
dv): its CUDA implementation launches, its fake one allocates the
gradients and the scratch (lse and delta, and at the wide pairs the
slices' parts, with :func:`wide_splits` at ``_build.H100_SMS`` SMs), its
flop formula counts the five products the kernel performs.
:func:`flash_attention_bwd_op` calls it; :func:`flash_attention_bwd_cuda`
also refuses tensor subclasses and tensors off the card.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Tuple

import torch

from .. import graphs
from . import _build
from .flash_attention import MASK_KINDS, mask_for

#: (D, Dv) pairs the backward is built for: yi-6b's, the 100M example's,
#: minicpm3-4b's MLA (qk 96 zero-padded to 128, v 64), deepseek-v2-lite's
#: MLA, recurrentgemma-2b's local attention, and the reduced configs'
#: (32, 32) and (64, 32) (reduced MLA, qk 48 padded to 64), which the
#: split kernels run on their (64, 64) tiles (:func:`tile_dims`).  The
#: forward's (64, 128) has no backward: no model of the zoo pads to it.
HEAD_DIMS = ((64, 64), (128, 128), (128, 64), (192, 128), (256, 256),
             (32, 32), (64, 32))
#: The kernel's tiles: keys per dK/dV CTA and per dQ ring stage (BN),
#: queries per dK/dV step and per dQ warpgroup (BM), queries per dQ CTA
#: (Q_BM), and the depth of both rings.
BN, BM, Q_BM, STAGES = 64, 64, 128, 4
#: The pairs the wide kernels take (the C entry point's ``wide``): both
#: warpgroups of a CTA work on the same dK/dV steps (:func:`dkdv_steps`'
#: list) or dQ key tiles (:func:`dq_tiles_wide`, BM queries a CTA, BN / 2
#: keys of each tile a warpgroup).  The split kernels take the others.
WIDE_PAIRS = ((192, 128), (256, 256))
#: The dK/dV ring has WKV_STAGES stages and P^T passes between its
#: warpgroups through HANDOFF bf16 buffers; the dQ kernel's K and V rings
#: have WQ_K_STAGES and WQ_V_STAGES.
WKV_STAGES, HANDOFF, WQ_K_STAGES, WQ_V_STAGES = 2, 2, 3, 2
#: TMA box width: a tile is whole boxes of BOX columns.
BOX = 64


def tile_dims(D: int, Dv: int) -> Tuple[int, int]:
    """The widths of the product kernels' tiles for the pair (D, Dv)
    (``tile_width`` in the source): a dim under one box runs in one box,
    whose columns past the tensor its tensor map reads as zeros."""
    return max(D, BOX), max(Dv, BOX)


def smem_bytes(D: int, Dv: int) -> Tuple[int, int]:
    """Dynamic shared memory of the (dK/dV, dQ) kernels.  dK/dV: K and V of
    64 keys, then per ring stage Q and dO of 64 queries and their lse and
    delta (fp32), a full mbarrier per stage and K/V's; dQ: Q and dO of 128
    queries, then per stage K and V of 64 keys, a full and an empty
    mbarrier per stage and Q/dO's; both bf16, plus 1024 bytes to align.
    The wide kernels (``WIDE_PAIRS``): dK/dV the same sections over
    WKV_STAGES stages, then HANDOFF bf16 64 x 64 tiles of P^T, K/V's
    mbarrier, three a stage and two a tile; dQ: Q and dO of BM queries,
    WQ_K_STAGES stages of K and WQ_V_STAGES of V, Q/dO's mbarrier and two
    a stage.  Mirrors
    ``KvLayout``, ``QLayout``, ``KvWideLayout`` and ``QWideLayout`` in
    ``csrc/flash_attention_bwd.cu``, at the pair's :func:`tile_dims`."""
    D, Dv = tile_dims(D, Dv)
    if (D, Dv) in WIDE_PAIRS:
        kv = (2 * BN * (D + Dv) + WKV_STAGES * (2 * BM * (D + Dv)
                                                + 2 * BM * 4)
              + HANDOFF * BN * BM * 2
              + 8 * (1 + 3 * WKV_STAGES + 2 * HANDOFF) + 1024)
        dq = (2 * BM * (D + Dv) + 2 * BN * (WQ_K_STAGES * D
                                             + WQ_V_STAGES * Dv)
              + 8 * (1 + 2 * WQ_K_STAGES + 2 * WQ_V_STAGES) + 1024)
        return kv, dq
    kv = (2 * BN * (D + Dv) + STAGES * (2 * BM * (D + Dv) + 2 * BM * 4)
          + 8 * (1 + STAGES) + 1024)
    dq = 2 * Q_BM * (D + Dv) + STAGES * 2 * BN * (D + Dv) \
        + 8 * (1 + 2 * STAGES) + 1024
    return kv, dq


def _edge(m0: int, n0: int, Sq: int, Sk: int, mask_kind: str, window: int,
          q_offset: int) -> bool:
    """Whether the BM x BN tile at (m0, n0) needs the mask (the kernel's
    ``edge_tile``): a pair past Sq or Sk, or one the mask may hide."""
    return (m0 + BM > Sq or n0 + BN > Sk
            or (mask_kind != "none" and n0 + BN - 1 > q_offset + m0)
            or (mask_kind == "window"
                and n0 <= q_offset + m0 + BM - 1 - window))


def dkdv_steps(n0: int, Sq: int, Sk: int, G: int, mask_kind: str,
               window: int = 0, q_offset: int = 0
               ) -> List[Tuple[int, int, int, bool]]:
    """The steps of the dK/dV CTA of the key tile at ``n0``, in order
    (step i goes to ring stage i % STAGES): ``(head in the group, query
    tile, warpgroup, edge)``.  The query tiles are those that can see a
    key of the tile; the two warpgroups take the steps in turns."""
    m_lo, m_hi = 0, Sq
    if mask_kind != "none":
        m_lo = max(0, n0 - q_offset)
        if mask_kind == "window":
            m_hi = min(Sq, n0 + BN - 1 + window - q_offset)
    t_lo = m_lo // BM
    n_qt = (m_hi + BM - 1) // BM - t_lo if m_hi > m_lo else 0
    return [(i // n_qt, t_lo + i % n_qt, i % 2,
             _edge((t_lo + i % n_qt) * BM, n0, Sq, Sk, mask_kind, window,
                   q_offset))
            for i in range(G * n_qt)]


def dq_tiles(m0: int, Sq: int, Sk: int, mask_kind: str, window: int = 0,
             q_offset: int = 0) -> List[Tuple[int, int, bool, bool]]:
    """The key tiles of the dQ CTA of the queries from ``m0`` (the
    forward's key range), each for both warpgroups: ``(key tile,
    warpgroup, sees, edge)``; a warpgroup computes on a tile only where
    one of its 64 rows sees one of its keys (``sees``)."""
    n_lo, n_hi = 0, Sk
    if mask_kind != "none":
        n_hi = min(Sk, q_offset + m0 + Q_BM)
        if mask_kind == "window":
            n_lo = max(0, q_offset + m0 - window + 1)
    t_lo = n_lo // BN
    out = []
    for t in range(t_lo, max(t_lo, (n_hi + BN - 1) // BN)):
        n0 = t * BN
        for wg in (0, 1):
            m0w = m0 + BM * wg
            sees = m0w < Sq
            if mask_kind != "none":
                sees = sees and n0 <= q_offset + m0w + BM - 1
            if mask_kind == "window":
                sees = sees and n0 + BN - 1 > q_offset + m0w - window
            out.append((t, wg, sees, sees and _edge(
                m0w, n0, Sq, Sk, mask_kind, window, q_offset)))
    return out


def dq_tiles_wide(m0: int, Sq: int, Sk: int, mask_kind: str,
                  window: int = 0, q_offset: int = 0
                  ) -> List[Tuple[int, bool]]:
    """The key tiles of the wide dQ CTA of the BM queries from ``m0``, in
    order: ``(key tile, edge)``.  Its range ends at the last key its last
    row (before Sq) sees, so every tile holds a visible pair."""
    n_lo, n_hi = 0, Sk
    if mask_kind != "none":
        n_hi = min(Sk, q_offset + min(m0 + BM, Sq))
        if mask_kind == "window":
            n_lo = max(0, q_offset + m0 - window + 1)
    if n_hi <= n_lo:
        return []
    t_lo = n_lo // BN
    return [(t, _edge(m0, t * BN, Sq, Sk, mask_kind, window, q_offset))
            for t in range(t_lo, (n_hi + BN - 1) // BN)]


def wide_splits(B: int, Sq: int, Sk: int, H: int, KV: int, mask_kind: str,
                window: int = 0, q_offset: int = 0, *, sms: int) -> int:
    """The slices of each KV group's heads that the wide dK/dV kernel takes
    one CTA each: the fewest whose heaviest CTA (ceil(G / slices) heads of
    the key tile with the most query tiles) walks no more steps than the
    whole grid's average over ``sms`` SMs.  The slices' fp32 parts are
    summed by a second launch; one slice writes the bf16 gradients
    itself."""
    G = H // KV
    n_qt = [len(dkdv_steps(n0, Sq, Sk, 1, mask_kind, window, q_offset))
            for n0 in range(0, Sk, BN)]
    per_sm = -(-B * KV * G * sum(n_qt) // sms)
    for splits in range(1, G + 1):
        if -(-G // splits) * max(n_qt, default=0) <= per_sm:
            return splits
    return G


def slice_heads(G: int, splits: int) -> List[range]:
    """The heads of a KV group (0 .. G - 1) that each slice of the wide
    dK/dV kernel takes, in the order the parts are summed: ceil(G /
    splits) a slice, the last cut at G."""
    per = -(-G // splits)
    return [range(r * per, min(G, (r + 1) * per)) for r in range(splits)]


def wide_ctas(device: torch.device, D: int, Dv: int) -> Tuple[int, int]:
    """CTAs of the wide (dK/dV, dQ) kernels of the wide pair (D, Dv) an SM
    holds at once (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    lib = _lib()
    out = []
    for kernel in (0, 1):
        n = ctypes.c_int(0)
        status = lib.flash_attention_bwd_wide_ctas(D, Dv, kernel,
                                                   ctypes.byref(n),
                                                   device.index)
        _build.check(lib, status, "flash_attention_bwd_wide_ctas")
        out.append(n.value)
    return out[0], out[1]


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
    lib.flash_attention_bwd.argtypes = [p] * 11 + [i] * 11 + [
        ctypes.c_float, i, p]
    lib.flash_attention_bwd.restype = ctypes.c_int
    lib.flash_attention_bwd_smem_bytes.argtypes = [i, i, i]
    lib.flash_attention_bwd_smem_bytes.restype = ctypes.c_long
    lib.flash_attention_bwd_wide_ctas.argtypes = [i, i, i, ctypes.POINTER(i),
                                                  i]
    lib.flash_attention_bwd_wide_ctas.restype = ctypes.c_int
    return lib


def _check(q, k, v, out, dout, lse, mask_kind: str, real: bool) -> None:
    """Raise on anything the kernel does not take; ``real`` also checks
    what only a tensor with storage has (the device, the alignment)."""
    B, Sq, H, D = q.shape
    if k.dim() != 4 or v.dim() != 4:
        raise ValueError("k and v must be [B, Sk, KV, D]")
    Sk, KV, Dv = k.shape[1], k.shape[2], v.shape[-1]
    dev = q.device
    if real and dev.type != "cuda":
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
        _build.check_tensor(name, t, torch.bfloat16, shape, dev, real)
        if real and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    _build.check_tensor("lse", lse, torch.float32, (B, Sq, H), dev, real)


def _allocate(q, k, v, mask_kind: str, window: int, q_offset: int,
              sms: int):
    """``(dq, dk, dv, stats, part, splits)`` of a launch on ``sms`` SMs:
    the gradients, lse log2(e) and delta per (batch, head) with the
    queries padded to BM rows, and at the wide pairs with more than one
    slice the slices' fp32 parts of dK, then dV (else None).  ``stats``
    is None where the launch has nothing to do."""
    B, Sq, H, D = q.shape
    Sk, KV, Dv = k.shape[1], k.shape[2], v.shape[-1]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if B == 0 or Sq == 0 or Sk == 0 or H == 0:
        return dq, dk, dv, None, None, 1
    stats = q.new_empty((B, H, 2, -(-Sq // BM) * BM), dtype=torch.float32)
    splits, part = 1, None
    if (D, Dv) in WIDE_PAIRS:
        splits = wide_splits(B, Sq, Sk, H, KV, mask_kind, window, q_offset,
                             sms=sms)
    if splits > 1:
        part = q.new_empty((splits * B * Sk * KV * (D + Dv),),
                           dtype=torch.float32)
    return dq, dk, dv, stats, part, splits


def _launch(q, k, v, out, dout, lse, mask_kind: str, window: int,
            q_offset: int, scale: float):
    """The op's CUDA implementation: check, allocate, launch."""
    _check(q, k, v, out, dout, lse, mask_kind, True)
    dev = q.device
    dq, dk, dv, stats, part, splits = _allocate(
        q, k, v, mask_kind, window, q_offset,
        torch.cuda.get_device_properties(dev).multi_processor_count)
    if stats is None:
        # nothing to attend to, or no query to attend: zero gradients
        return dq.zero_(), dk.zero_(), dv.zero_()
    B, Sq, H, D = q.shape
    Sk, KV, Dv = k.shape[1], k.shape[2], v.shape[-1]
    lib = _lib()
    status = lib.flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), stats.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(),
        part.data_ptr() if part is not None else None, splits, B, Sq, Sk, H,
        KV, D, Dv,
        MASK_KINDS[mask_kind], int(window), int(q_offset), float(scale),
        dev.index, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, status, "flash_attention_bwd")
    graphs.count(flash_attention_bwd_cuda)
    return dq, dk, dv


def _plain(q, k, v, out, dout, lse, mask_kind: str, window: int,
           q_offset: int, scale: float):
    """The op's CPU implementation: the plain formula (float32), laid out
    as the kernel lays its outputs."""
    return tuple(g.contiguous() for g in flash_attention_bwd_plain(
        q, k, v, out, dout, lse, mask_kind=mask_kind, window=window,
        q_offset=q_offset, scale=scale))


def _fake(q, k, v, out, dout, lse, mask_kind: str, window: int,
          q_offset: int, scale: float):
    _check(q, k, v, out, dout, lse, mask_kind, False)
    dq, dk, dv, stats, part, _ = _allocate(q, k, v, mask_kind, window,
                                           q_offset, _build.H100_SMS)
    _build.fake_scratch(stats, part)
    return dq, dk, dv


def flops(q_shape, k_shape, v_shape, out_shape_, dout_shape, lse_shape,
          mask_kind, window, q_offset, scale, out_shape=None) -> int:
    """The five products the kernel performs, over every (query, key)
    pair as the plain formula counts them: QK^T recomputed and dO V^T (D
    and Dv deep), dV = P^T dO, dK = dS^T Q and dQ = dS K."""
    B, Sq, H, D = q_shape
    Sk, Dv = k_shape[1], v_shape[-1]
    return 2 * B * H * Sq * Sk * (3 * D + 2 * Dv)


OP = _build.define_op(
    "flash_attention_bwd",
    "(Tensor q, Tensor k, Tensor v, Tensor out, Tensor dout, Tensor lse, "
    "str mask_kind, int window, int q_offset, float scale) "
    "-> (Tensor, Tensor, Tensor)",
    cuda=_launch, cpu=_plain, fake=_fake, flops=flops)


def flash_attention_bwd_op(q, k, v, out, dout, lse, *,
                           mask_kind: str = "causal", window: int = 0,
                           q_offset: int = 0,
                           scale: Optional[float] = None) -> tuple:
    """The op: the kernel for CUDA tensors, the fake implementation for
    fake ones.  Returns ``(dq, dk, dv)``."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    return OP(q, k, v, out, dout, lse, mask_kind, int(window),
              int(q_offset), float(scale))


def flash_attention_bwd_cuda(q, k, v, out, dout, lse, *,
                             mask_kind: str = "causal", window: int = 0,
                             q_offset: int = 0,
                             scale: Optional[float] = None) -> tuple:
    """Launch the CUDA kernel.  Returns ``(dq, dk, dv)``, bf16."""
    _build.check_plain("flash_attention_bwd_cuda", q, k, v, out, dout, lse)
    if q.device.type != "cuda":
        raise ValueError(f"q must be a CUDA tensor, got {q.device}")
    return flash_attention_bwd_op(q, k, v, out, dout, lse,
                                  mask_kind=mask_kind, window=window,
                                  q_offset=q_offset, scale=scale)


#: Launches of the CUDA kernel since the last reset (``launches = 0``).
flash_attention_bwd_cuda.launches = 0
