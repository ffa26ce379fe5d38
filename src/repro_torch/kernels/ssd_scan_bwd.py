"""Mamba-2 SSD scan backward: the CUDA kernel's wrapper and its plain version.

The kernel (``csrc/ssd_scan_bwd.cu``) replaces the backward of the JAX
package's ``repro.kernels.ops.ssd`` (XLA autodiff of ``_ssd_chunked_xla``;
no Pallas kernel exists for it).  Given the forward's inputs, the
cotangent ``dy`` of y and (optionally) ``dstate`` of the final state, it
returns ``(dx, ddt, dA, dB, dC, d initial_state)``.  Its wrapper takes CUDA
tensors in the forward's layout (x and dy ``[B, S, H, P]`` bf16, dt ``[B,
S, H]`` fp32, A ``[H]`` fp32, B/C ``[B, S, G, N]`` bf16, initial state and
dstate ``[B, H, P, N]`` fp32), checks them, allocates the gradients and the
kernel's fp32 scratch and launches on PyTorch's current stream.  It raises
on anything the kernel does not take; it never falls back to the plain
version.  One call of the wrapper is one launch of the kernel (its three
CUDA kernels: the walks, the chunks, the reductions).

The math, per (batch, head) and chunk c (``ssd_scan.ssd_plain``'s forward;
cum_t the within-chunk cumsum of dt A, h_c the state entering the chunk,
dh the gradient of the state leaving it):

- dh_c = exp(total) dh + sum_t exp(cum_t) dy_t (x) C_t;
- u_s = sum_{t>=s} L[t, s] dy_t + exp(total - cum_s) dh B_s, with
  L[t, s] = (C_t . B_s) exp(cum_t - cum_s); dx_s = dt_s u_s and the direct
  part of ddt_s is x_s . u_s;
- with Z[t, s] = (dy_t . x_s) exp(cum_t - cum_s) dt_s (s <= t):
  dB_s = sum_t Z[t, s] C_t + exp(total - cum_s) dt_s x_s dh and
  dC_t = sum_s Z[t, s] B_s + exp(cum_t) dy_t h_c, per head, summed over
  the heads of a group;
- the gradient of cum_t is C_t . dC_t - B_t . dB_t (per head), plus
  <dh, h_{c+1}> at the chunk's last row (the gradient of its total);
  ddt_s adds A times its reverse cumsum, and dA is the sum of dt times it.

:func:`smem_bytes`, :func:`chunk_row_tiles` and
:func:`repro_torch.kernels.ssd_scan.state_tiles_per_warp` (the walks
carry their [P, N] state in registers as the forward does) mirror the
kernel's layouts and tiling so that CPU tests can check them;
:func:`flops` counts the products the gradients need and those the
kernel issues, for its bound.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Tuple

import torch

from . import _build
from .ssd_scan import MAX_SMEM, _chunk_len, _round16

# The kernel's block: 8 warps; chunk rows up to 256 (16 row tiles, two per
# warp), P and N up to 128 (its registers); bf16 rows padded by 8.
_WARPS, _MAX_Q, _MAX_P, _MAX_N, _PAD = 8, 256, 128, 128, 8
_LOG2E = 1.4426950408889634


def smem_bytes(Q: int, P: int, N: int) -> Tuple[int, int]:
    """Dynamic shared memory of the (walk, chunk) kernels for chunk ``Q``,
    head dim ``P`` and state dim ``N``, each padded to a multiple of 16.
    Walk: two staging buffers of U ``[Q][P + 8]`` and V ``[Q][N + 8]``
    (bf16) and dt ``[Q]`` (fp32), then cum and the rows' weights ``[Q]``
    (fp32).  Chunk: x and dy ``[Q][P + 8]``, B and C ``[Q][N + 8]``, the
    entering state and the state gradient ``[P][N + 8]`` (bf16); dt, cum,
    the rows' share of the gradient of cum, the direct part of ddt and
    its part from dh ``[Q]`` (fp32); one fp32 per warp for a block sum.  Mirrors ``WalkLayout`` and
    ``ChunkLayout`` in ``csrc/ssd_scan_bwd.cu``."""
    Qp, Pp, Np = _round16(Q), _round16(P), _round16(N)
    ldx, ldb = Pp + _PAD, Np + _PAD
    stage = 2 * Qp * ldx + 2 * Qp * ldb + 4 * Qp
    walk = 2 * stage + 2 * 4 * Qp
    chunk = (2 * 2 * Qp * ldx + 2 * 2 * Qp * ldb + 2 * 2 * Pp * ldb
             + 5 * 4 * Qp + 4 * _WARPS)
    return walk, chunk


def chunk_row_tiles(Q: int) -> List[List[int]]:
    """The 16-row tiles of a chunk each warp of the chunk kernel takes, in
    order: warp w takes tile w and, past eight tiles, tile 15 - w (a tile's
    work falls with its index in one product and grows in another; the
    pairs even it out).  Mirrors ``row_tile`` in the source."""
    nt = _round16(Q) // 16
    return [[r for r in (w, 15 - w) if r < nt] for w in range(_WARPS)]


def flops(Bsz: int, S: int, H: int, P: int, G: int, N: int,
          chunk: int = 128) -> Tuple[float, float]:
    """The backward's products at one shape, in FLOPs: ``(function,
    design)``.  The function's, the least the gradients need: per head and
    chunk five state products of Q·P·N (the walks' states and state
    gradients, dh·B for dx, x·dh for dB, dy·h for dC) and two triangles
    over P (L·dy for dx, and Z = dy·xᵀ); per group and chunk three
    triangles over N (C·Bᵀ, and Z∘decay summed over the group's heads
    times C and times B), a triangle counted by its Q(Q+1)/2 pairs.  The
    design's, what the kernel issues: every product per head at P and N
    padded to 16, the triangles by whole 16 x 16 blocks, C·Bᵀ per head and
    Z formed twice (x·dyᵀ for dB, dy·xᵀ for dC): three triangles over P
    and three over N."""
    Q = _chunk_len(S, chunk)
    nc = S // Q
    pairs = Q * (Q + 1) // 2
    function = 2.0 * Bsz * nc * (H * (5 * Q * P * N + 2 * pairs * P)
                                 + G * 3 * pairs * N)
    Qp, Pp, Np = _round16(Q), _round16(P), _round16(N)
    blocks = 256 * (Qp // 16) * (Qp // 16 + 1) // 2
    design = 2.0 * Bsz * H * nc * (5 * Qp * Pp * Np
                                   + blocks * 3 * (Pp + Np))
    return function, design


def _warp_cumsum(v: torch.Tensor) -> torch.Tensor:
    """Inclusive fp32 cumsum over dim 2 in the kernel's order
    (``chunk_cumsum``): rows in blocks of 32, a shuffle scan in each (at
    offsets 1, 2, 4, 8, 16), and the blocks' totals carried in order."""
    Q = v.shape[2]
    k = -(-Q // 32)
    pad = torch.zeros_like(v[:, :, :1]).expand(-1, -1, 32 * k - Q, -1)
    v = torch.cat([v, pad], 2).unflatten(2, (k, 32))
    for o in (1, 2, 4, 8, 16):
        v = v + torch.nn.functional.pad(v[:, :, :, :-o], (0, 0, o, 0))
    total = torch.zeros_like(v[:, :, 0, 0])
    blocks = []
    for i in range(k):
        blocks.append(v[:, :, i] + total[:, :, None])
        total = total + v[:, :, i, 31]
    return torch.cat(blocks, 2)[:, :, :Q]


def ssd_bwd_plain(x, dt, A, Bmat, Cmat, dy, dstate=None, *,
                  chunk: int = 128,
                  initial_state: Optional[torch.Tensor] = None,
                  dtype: torch.dtype = torch.float32) -> tuple:
    """The chunked backward written out in float32, chunk by chunk in
    reverse with the state gradient carried (the module docstring's
    formula).  ``dtype`` bfloat16 rounds the operands of each product to
    bf16 as the kernel does (the states, the state gradients, x and dy
    scaled by their rows' weights, L and Z) and sums cum in log2 units in
    the kernel's order, for the floor of the card's comparison.  Returns ``(dx, ddt, dA, dB, dC, dh0)`` in the dtypes of x,
    dt, A, B, C and fp32; ``dh0`` is None without ``initial_state``."""
    def rnd(t):
        return t.to(dtype).float()

    Bsz, S, H, P = x.shape
    G, N = Bmat.shape[2], Bmat.shape[3]
    rep = H // G
    Q = _chunk_len(S, chunk)
    nc = S // Q

    xf = x.float().reshape(Bsz, nc, Q, H, P)
    dyf = dy.float().reshape(Bsz, nc, Q, H, P)
    dtf = dt.float().reshape(Bsz, nc, Q, H)
    Af = A.float()
    Bh = Bmat.float().reshape(Bsz, nc, Q, G, N).repeat_interleave(rep, dim=3)
    Ch = Cmat.float().reshape(Bsz, nc, Q, G, N).repeat_interleave(rep, dim=3)

    if dtype == torch.float32:
        cum, ex = torch.cumsum(dtf * Af, dim=2), torch.exp   # [B,nc,Q,H]
    else:
        # cum in log2 units, summed in the kernel's order
        cum, ex = _warp_cumsum(dtf * (Af * _LOG2E)), torch.exp2
    total = cum[:, :, -1, :]                             # [B,nc,H]
    w = ex(total[:, :, None, :] - cum) * dtf      # exp(total-cum_s) dt_s
    ecum = ex(cum)

    # The states entering each chunk, recomputed by a forward walk, and the
    # final one: H[:, c] enters chunk c, H[:, c + 1] leaves it.
    chunk_state = torch.einsum("bcqhp,bcqhn->bchpn",
                               rnd(xf * w[..., None]), Bh)
    h = (initial_state.float() if initial_state is not None
         else x.new_zeros((Bsz, H, P, N), dtype=torch.float32))
    states = [h]
    for c in range(nc):
        h = h * ex(total[:, c])[..., None, None] + chunk_state[:, c]
        states.append(h)
    Hs = torch.stack(states, dim=1)                      # [B,nc+1,H,P,N]

    # The gradients of the states leaving each chunk, by a reverse walk.
    dstate_in = torch.einsum("bcqhp,bcqhn->bchpn",
                             rnd(dyf * ecum[..., None]), Ch)
    dh = (dstate.float() if dstate is not None
          else x.new_zeros((Bsz, H, P, N), dtype=torch.float32))
    dhs = [None] * nc
    for c in reversed(range(nc)):
        dhs[c] = dh
        dh = dh * ex(total[:, c])[..., None, None] + dstate_in[:, c]
    DH = torch.stack(dhs, dim=1)                         # [B,nc,H,P,N]

    # Within each chunk: decay[t, s] = exp(cum_t - cum_s) for s <= t, masked
    # inside the exponent (a positive difference would overflow to inf).
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # [B,nc,t,s,H]
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    decay = ex(diff.masked_fill(~tri[None, None, :, :, None],
                                       float("-inf")))
    L = torch.einsum("bcthn,bcshn->bctsh", Ch, Bh) * decay
    Z = torch.einsum("bcthp,bcshp->bctsh", dyf, xf) * decay \
        * dtf[:, :, None, :, :]
    eye = torch.eye(Q, dtype=torch.bool, device=x.device)
    Zs = Z.masked_fill(eye[None, None, :, :, None], 0.0)  # s < t only
    zd = dtf * (dyf * xf).sum(-1)                        # Z[t, t]

    # dx and the direct part of ddt; F_s, the part of x_s . u_s that comes
    # from dh (times dt_s), on its own.
    u_dh = ex(total[:, :, None, :] - cum)[..., None] \
        * torch.einsum("bcshn,bchpn->bcshp", Bh, rnd(DH))
    f = dtf * (xf * u_dh).sum(-1)
    u = u_dh + torch.einsum("bctsh,bcthp->bcshp", rnd(L), dyf)
    dx = dtf[..., None] * u
    g = (xf * u).sum(-1)

    # Per head: dB_s = sum_{t>s} Z[t,s] C_t + Z[s,s] C_s + w_s x_s dh and
    # dC_t = sum_{s<t} Z[t,s] B_s + exp(cum_t) dy_t h_c + Z[t,t] B_t.
    dB_lo = torch.einsum("bctsh,bcthn->bcshn", rnd(Zs), Ch)
    dBh = dB_lo + zd[..., None] * Ch + torch.einsum(
        "bcshp,bchpn->bcshn", rnd(xf * w[..., None]), rnd(DH))
    dC_lo = torch.einsum("bctsh,bcshn->bcthn", rnd(Zs), Bh) \
        + ecum[..., None] * torch.einsum("bcthp,bchpn->bcthn", dyf,
                                         rnd(Hs[:, :nc]))
    dCh = dC_lo + zd[..., None] * Bh

    # The gradient of cum, summed from each row to the chunk's end (da,
    # the gradient of dt_s A), with no two terms that cancel: the diagonal
    # of L and Z drops out of C . dC - B . dB, and the F terms of rows
    # t >= s cancel against the total's, leaving those of rows t < s.
    dcum = (Ch * dC_lo).sum(-1) - (Bh * dB_lo).sum(-1)  # [B,nc,Q,H]
    da = torch.flip(torch.cumsum(torch.flip(dcum, (2,)), 2), (2,)) \
        + (ex(total) * (DH * Hs[:, :nc]).sum((-1, -2)))[:, :, None] \
        + torch.cumsum(f, 2) - f
    ddt = g + Af * da
    dA = (da * dtf).sum((0, 1, 2))

    dB = dBh.reshape(Bsz, S, G, rep, N).sum(3)
    dC = dCh.reshape(Bsz, S, G, rep, N).sum(3)
    return (dx.reshape(Bsz, S, H, P).to(x.dtype),
            ddt.reshape(Bsz, S, H).to(dt.dtype), dA.to(A.dtype),
            dB.to(Bmat.dtype), dC.to(Cmat.dtype),
            dh if initial_state is not None else None)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("ssd_scan_bwd")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ssd_scan_bwd.argtypes = [p] * 19 + [i] * 8 + [p]
    lib.ssd_scan_bwd.restype = ctypes.c_int
    lib.ssd_scan_bwd_smem_bytes.argtypes = [i, i, i, i]
    lib.ssd_scan_bwd_smem_bytes.restype = ctypes.c_long
    return lib


def ssd_bwd_cuda(x, dt, A, Bmat, Cmat, dy, dstate=None, *, chunk: int = 128,
                 initial_state: Optional[torch.Tensor] = None) -> tuple:
    """Launch the CUDA kernel.  Returns ``(dx, ddt, dA, dB, dC, dh0)``:
    bf16, fp32, fp32, bf16, bf16 and fp32 (None without
    ``initial_state``).  ``dstate`` None counts as zeros."""
    if x.dim() != 4 or Bmat.dim() != 4:
        raise ValueError("x must be [B, S, H, P] and B, C [B, S, G, N]")
    Bsz, S, H, P = x.shape
    G, N = Bmat.shape[2], Bmat.shape[3]
    state = (Bsz, H, P, N)
    args = [("x", x, torch.bfloat16, (Bsz, S, H, P)),
            ("dt", dt, torch.float32, (Bsz, S, H)),
            ("A", A, torch.float32, (H,)),
            ("B", Bmat, torch.bfloat16, (Bsz, S, G, N)),
            ("C", Cmat, torch.bfloat16, (Bsz, S, G, N)),
            ("dy", dy, torch.bfloat16, (Bsz, S, H, P))]
    if dstate is not None:
        args.append(("dstate", dstate, torch.float32, state))
    if initial_state is not None:
        args.append(("initial_state", initial_state, torch.float32, state))
    for name, t, dtype, shape in args:
        _build.check_tensor(name, t, dtype, shape, x.device)
    if G == 0 or H % G:
        raise ValueError(f"n_heads {H} is not a multiple of n_groups {G}")
    Q = _chunk_len(S, chunk)
    if Q > _MAX_Q or not 0 < P <= _MAX_P or not 0 < N <= _MAX_N:
        raise ValueError(f"the backward takes chunks of at most {_MAX_Q}, "
                         f"head dims 1..{_MAX_P} and state dims "
                         f"1..{_MAX_N}, got chunk {Q}, P {P}, N {N}")
    smem = max(smem_bytes(Q, P, N))
    if smem > MAX_SMEM:
        raise ValueError(f"chunk {Q}, head dim {P}, state dim {N} need "
                         f"{smem} bytes of shared memory (at most "
                         f"{MAX_SMEM})")
    lib = _lib()
    dev = x.device
    nc = S // Q
    dx = torch.empty_like(x)
    ddt = torch.empty_like(dt)
    dA = torch.empty_like(A)
    dB = torch.empty_like(Bmat)
    dC = torch.empty_like(Cmat)
    dh0 = torch.empty(state, dtype=torch.float32, device=dev) \
        if initial_state is not None else None
    if Bsz == 0 or H == 0:
        for t in (dA, dB, dC):
            t.zero_()
        return dx, ddt, dA, dB, dC, dh0
    f32 = dict(dtype=torch.float32, device=dev)
    # Scratch: the states entering each chunk and the last one, the
    # gradients of the states leaving each chunk (both [P, N] padded to
    # multiples of 16), per-head dB and dC, and dA per (batch, head,
    # chunk); summed in a fixed order, no atomics.
    Pp, Np = _round16(P), _round16(N)
    states = torch.empty((Bsz, H, nc + 1, Pp, Np), **f32)
    dstates = torch.empty((Bsz, H, nc, Pp, Np), **f32)
    part_b = torch.empty((Bsz, S, H, N), **f32)
    part_c = torch.empty((Bsz, S, H, N), **f32)
    part_a = torch.empty((Bsz, H, nc), **f32)

    def ptr(t):
        return t.data_ptr() if t is not None else None

    status = lib.ssd_scan_bwd(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bmat.data_ptr(),
        Cmat.data_ptr(), dy.data_ptr(), ptr(dstate), ptr(initial_state),
        states.data_ptr(), dstates.data_ptr(), part_b.data_ptr(),
        part_c.data_ptr(), part_a.data_ptr(), dx.data_ptr(),
        ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(), dC.data_ptr(),
        ptr(dh0), Bsz, S, H, P, G, N, Q, dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, status, "ssd_scan_bwd")
    ssd_bwd_cuda.launches += 1
    return dx, ddt, dA, dB, dC, dh0


#: Launches of the CUDA kernel since the last reset (``launches = 0``).
ssd_bwd_cuda.launches = 0
