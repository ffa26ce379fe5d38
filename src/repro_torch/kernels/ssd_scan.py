"""Mamba-2 SSD scan: the CUDA kernel's wrapper and its plain version.

The kernel (``csrc/ssd_scan.cu``) replaces the Pallas TPU kernel
``repro.kernels.ssd_scan.ssd_pallas``: one CTA per (batch, head) walks the
chunks with the products on the tensor cores and the fp32 state in
registers; :func:`smem_bytes` and :func:`state_tiles_per_warp` mirror its
shared-memory layout and its state tiling.  Its wrapper takes CUDA tensors in
the JAX package's layout (x ``[B, S, H, P]`` bf16, dt ``[B, S, H]`` fp32,
A ``[H]`` fp32, B/C ``[B, S, G, N]`` bf16, optional initial state ``[B, H,
P, N]`` fp32), checks them, allocates y (bf16) and the final state (fp32)
and launches on PyTorch's current stream.  Unlike the Pallas kernel it
takes ``initial_state`` itself.  It raises on anything the kernel does not
take; it never falls back to the plain version.

The launch is the operator ``torch.ops.repro_torch.ssd_scan`` (x, dt, A,
B, C, initial_state or None, chunk) -> (y, state): its CUDA implementation
launches, its fake one allocates the same outputs (the kernel needs no
scratch), its flop formula (:func:`flops`) counts the products the kernel
issues.  :func:`ssd_op` calls it; :func:`ssd_cuda` also refuses tensor
subclasses and tensors off the card.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from .. import graphs
from . import _build

#: Dynamic shared memory one CTA may use on an H100 (227 KB opt-in).
MAX_SMEM = 232448
# The kernel's block: 8 warps; chunk rows up to 256 (two 16-row tiles per
# warp), P up to 128 (its y accumulator), at most 16 n8 tiles of the state
# per warp (its registers); bf16 rows padded by 8 elements.
_WARPS, _MAX_Q, _MAX_P, _MAX_STATE_TILES, _PAD = 8, 256, 128, 16, 8


def _round16(v: int) -> int:
    return -(-v // 16) * 16


def smem_bytes(Q: int, P: int, N: int) -> int:
    """Shared memory of one CTA for chunk ``Q``, head dim ``P`` and state
    dim ``N``, each padded to a multiple of 16: two staging buffers of x
    ``[Q][P + 8]``, B and C ``[Q][N + 8]`` (bf16) and dt ``[Q]`` (fp32);
    the bf16 state ``[P][N + 8]``; cum and w ``[Q]`` (fp32); the partial y
    tiles warps hand over ``[4][16 P]`` (fp32); each warp's outgoing y tile
    ``[16][P + 8]`` (bf16); two 8-byte mbarriers.  Mirrors ``Layout`` in
    ``csrc/ssd_scan.cu``."""
    Qp, Pp, Np = _round16(Q), _round16(P), _round16(N)
    stage = 2 * Qp * (Pp + _PAD) + 2 * 2 * Qp * (Np + _PAD) + 4 * Qp
    return (2 * stage + 2 * Pp * (Np + _PAD) + 2 * 4 * Qp
            + 4 * (_WARPS // 2) * 16 * Pp + 2 * _WARPS * 16 * (Pp + _PAD)
            + 16)


def state_tiles_per_warp(P: int, N: int) -> int:
    """n8 tiles of the fp32 state each warp holds in registers: the warps
    form a grid over P's 16-row tiles (a power of two) and N's n8 tiles.
    Mirrors ``Tiling`` in ``csrc/ssd_scan.cu``."""
    wm = 1
    while wm < _round16(P) // 16:
        wm *= 2
    wn = max(1, _WARPS // wm)
    nw = -(-(_round16(N) // 8) // wn)
    return nw + nw % 2


def _chunk_len(S: int, chunk: int) -> int:
    Q = min(chunk, S)
    if Q <= 0 or S % Q:
        raise ValueError(f"sequence length {S} is not a multiple of the "
                         f"chunk length {Q}")
    return Q


def ssd_plain(x, dt, A, Bmat, Cmat, *, chunk: int = 128,
              initial_state: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD in float32 (``repro.kernels.ops._ssd_chunked_xla``):
    quadratic intra-chunk term plus the linear inter-chunk recurrence of
    the [P, N] state.  Returns (y in x's dtype, final state fp32)."""
    Bsz, S, H, P = x.shape
    G, N = Bmat.shape[2], Bmat.shape[3]
    rep = H // G
    Q = _chunk_len(S, chunk)
    nc = S // Q

    xf = x.float().reshape(Bsz, nc, Q, H, P)
    dtf = dt.float().reshape(Bsz, nc, Q, H)
    Bh = Bmat.float().reshape(Bsz, nc, Q, G, N).repeat_interleave(rep, dim=3)
    Ch = Cmat.float().reshape(Bsz, nc, Q, G, N).repeat_interleave(rep, dim=3)

    dA = dtf * A.float()[None, None, None, :]            # [B,nc,Q,H] (<=0)
    cum = torch.cumsum(dA, dim=2)                        # within-chunk cumsum
    total = cum[:, :, -1:, :]                            # [B,nc,1,H]

    # intra-chunk: decay[t, s] = exp(cum_t - cum_s) for s <= t.  Mask inside
    # the exponent: for s > t the difference is positive, exp() overflows to
    # inf, and inf * 0 = NaN if masked after the fact.
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # [B,nc,Q,Q,H]
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    decay = torch.exp(diff.masked_fill(~tri[None, None, :, :, None],
                                       float("-inf")))
    scores = torch.einsum("bcqhn,bckhn->bcqkh", Ch, Bh)  # [B,nc,Q,Q,H]
    L = scores * decay
    y_intra = torch.einsum("bcqkh,bckh,bckhp->bcqhp", L, dtf, xf)

    # chunk states: sum_s exp(total - cum_s) dt_s x_s (x) B_s -> [B,nc,H,P,N]
    w = torch.exp(total - cum) * dtf                     # [B,nc,Q,H]
    chunk_state = torch.einsum("bcqh,bcqhp,bcqhn->bchpn", w, xf, Bh)

    # inter-chunk recurrence, keeping the state entering each chunk
    chunk_decay = torch.exp(total[:, :, 0, :])           # [B,nc,H]
    h = (initial_state.float() if initial_state is not None
         else torch.zeros((Bsz, H, P, N), device=x.device))
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        h = h * chunk_decay[:, c, :, None, None] + chunk_state[:, c]
    h_prev = torch.stack(h_prev, dim=1)                  # [B,nc,H,P,N]

    y_inter = torch.einsum("bcqhn,bchpn->bcqhp",
                           Ch * torch.exp(cum)[..., None], h_prev)
    y = (y_intra + y_inter).reshape(Bsz, S, H, P)
    return y.to(x.dtype), h


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("ssd_scan")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ssd_scan_fwd.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i, i,
                                 i, p]
    lib.ssd_scan_fwd.restype = ctypes.c_int
    lib.ssd_scan_smem_bytes.argtypes = [i, i, i]
    lib.ssd_scan_smem_bytes.restype = ctypes.c_long
    return lib


def _check(x, dt, A, Bmat, Cmat, initial_state, chunk: int,
           real: bool) -> int:
    """Raise on anything the kernel does not take (``real`` also checks
    the device); returns the chunk the kernel runs."""
    if x.dim() != 4 or Bmat.dim() != 4:
        raise ValueError("x must be [B, S, H, P] and B, C [B, S, G, N]")
    Bsz, S, H, P = x.shape
    G, N = Bmat.shape[2], Bmat.shape[3]
    args = [("x", x, torch.bfloat16, (Bsz, S, H, P)),
            ("dt", dt, torch.float32, (Bsz, S, H)),
            ("A", A, torch.float32, (H,)),
            ("B", Bmat, torch.bfloat16, (Bsz, S, G, N)),
            ("C", Cmat, torch.bfloat16, (Bsz, S, G, N))]
    if initial_state is not None:
        args.append(("initial_state", initial_state, torch.float32,
                     (Bsz, H, P, N)))
    for name, t, dtype, shape in args:
        _build.check_tensor(name, t, dtype, shape, x.device, real)
    if G == 0 or H % G:
        raise ValueError(f"n_heads {H} is not a multiple of n_groups {G}")
    Q = _chunk_len(S, chunk)
    smem = smem_bytes(Q, P, N)
    if smem > MAX_SMEM:
        raise ValueError(f"chunk {Q}, head dim {P}, state dim {N} need "
                         f"{smem} bytes of shared memory (at most "
                         f"{MAX_SMEM})")
    if Q > _MAX_Q or P > _MAX_P or P == 0 or N == 0:
        raise ValueError(f"the kernel takes chunks of at most {_MAX_Q} and "
                         f"head dims 1..{_MAX_P}, got chunk {Q}, P {P}, "
                         f"N {N}")
    if state_tiles_per_warp(P, N) > _MAX_STATE_TILES:
        raise ValueError(f"a [{P}, {N}] state does not fit the kernel's "
                         f"registers (at most {_MAX_STATE_TILES} n8 tiles "
                         f"per warp)")
    return Q


def _outputs(x, Bmat):
    Bsz, _, H, P = x.shape
    return (torch.empty_like(x),
            x.new_empty((Bsz, H, P, Bmat.shape[3]), dtype=torch.float32))


def _launch(x, dt, A, Bmat, Cmat, initial_state, chunk: int):
    """The op's CUDA implementation: check, allocate, launch."""
    Q = _check(x, dt, A, Bmat, Cmat, initial_state, chunk, True)
    Bsz, S, H, P = x.shape
    G, N = Bmat.shape[2], Bmat.shape[3]
    lib = _lib()
    y, state = _outputs(x, Bmat)
    if Bsz == 0 or H == 0:
        return y, state
    status = lib.ssd_scan_fwd(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bmat.data_ptr(),
        Cmat.data_ptr(),
        initial_state.data_ptr() if initial_state is not None else None,
        y.data_ptr(), state.data_ptr(), Bsz, S, H, P, G, N, Q,
        x.device.index, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, status, "ssd_scan_fwd")
    graphs.count(ssd_cuda)
    return y, state


def _plain(x, dt, A, Bmat, Cmat, initial_state, chunk: int):
    """The op's CPU implementation: the plain version, laid out as the
    kernel lays its outputs."""
    y, state = ssd_plain(x, dt, A, Bmat, Cmat, chunk=chunk,
                         initial_state=initial_state)
    return (y.clone(memory_format=torch.contiguous_format),
            state.clone(memory_format=torch.contiguous_format))


def _fake(x, dt, A, Bmat, Cmat, initial_state, chunk: int):
    _check(x, dt, A, Bmat, Cmat, initial_state, chunk, False)
    return _outputs(x, Bmat)


def flops(x_shape, dt_shape, A_shape, B_shape, C_shape, h0_shape, chunk,
          out_shape=None) -> int:
    """The products the kernel issues, Q, P and N padded to 16: per
    (batch, head, chunk) C B^T and L x on the 16 x 16 blocks on and
    below the diagonal (T (T + 1) / 2 of them, T = Q / 16), C state^T
    and the chunk's state update (x o w)^T B."""
    Bsz, S, H, P = x_shape
    N = B_shape[3]
    Q = _chunk_len(S, chunk)
    Qp, Pp, Np = _round16(Q), _round16(P), _round16(N)
    T = Qp // 16
    per_chunk = T * (T + 1) // 2 * 256 * (Np + Pp) + 2 * Qp * Pp * Np
    return 2 * Bsz * H * (S // Q) * per_chunk


OP = _build.define_op(
    "ssd_scan",
    "(Tensor x, Tensor dt, Tensor A, Tensor B, Tensor C, "
    "Tensor? initial_state, int chunk) -> (Tensor, Tensor)",
    cuda=_launch, cpu=_plain, fake=_fake, flops=flops)


def ssd_op(x, dt, A, Bmat, Cmat, *, chunk: int = 128,
           initial_state: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The op: the kernel for CUDA tensors, the fake implementation for
    fake ones.  Returns ``(y, state)``."""
    return OP(x, dt, A, Bmat, Cmat, initial_state, int(chunk))


def ssd_cuda(x, dt, A, Bmat, Cmat, *, chunk: int = 128,
             initial_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel.  Returns (y ``[B, S, H, P]`` bf16, final
    state ``[B, H, P, N]`` fp32)."""
    _build.check_plain("ssd_cuda", x, dt, A, Bmat, Cmat, initial_state)
    if x.device.type != "cuda":
        raise ValueError(f"x must be a CUDA tensor, got {x.device}")
    return ssd_op(x, dt, A, Bmat, Cmat, chunk=chunk,
                  initial_state=initial_state)


#: Launches of the CUDA kernel since the last reset (``launches = 0``).
ssd_cuda.launches = 0
