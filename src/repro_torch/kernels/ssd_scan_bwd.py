"""Mamba-2 SSD scan backward: the CUDA kernel's wrapper and its plain version.

The kernel (``csrc/ssd_scan_bwd.cu``) replaces the backward of the JAX
package's ``repro.kernels.ops.ssd`` (XLA autodiff of ``_ssd_chunked_xla``;
no Pallas kernel exists for it).  Given the forward's inputs, the
cotangent ``dy`` of y and (optionally) ``dstate`` of the final state, it
returns ``(dx, ddt, dA, dB, dC, d initial_state)``.  Its wrapper takes CUDA
tensors in the forward's layout (x and dy ``[B, S, H, P]`` bf16, dt ``[B,
S, H]`` fp32, A ``[H]`` fp32, B/C ``[B, S, G, N]`` bf16, initial state and
dstate ``[B, H, P, N]`` fp32), checks them, allocates the gradients and the
kernel's scratch and launches on PyTorch's current stream.  It raises
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

The kernels run chunks of at most 128 rows that fit their shared memory
(:func:`kernel_chunk`: a longer chunk runs as equal sub-chunks of at least
16 rows, the same function).  Their chunk
pass takes a group's heads in slices of R a CTA (:func:`plan`,
:func:`chunk_schedule`).  :func:`smem_bytes`, :func:`chunk_schedule` and
:func:`repro_torch.kernels.ssd_scan.state_tiles_per_warp` (the walks
carry their [P, N] state in registers as the forward does) mirror the
kernel's layouts and tiling so that CPU tests can check them;
:func:`flops` counts the products the gradients need and those the
kernel issues, for its bound.

The launch is the operator ``torch.ops.repro_torch.ssd_scan_bwd`` (x, dt,
A, B, C, dy, dstate or None, initial_state or None, chunk) -> (dx, ddt,
dA, dB, dC, dh0), dh0 empty without an initial state: its CUDA
implementation launches, its fake one allocates the gradients and the
scratch (planned for ``_build.H100_SMS`` SMs), its flop formula counts
the products the kernels issue (:func:`flops`' design count).
:func:`ssd_bwd_op` calls it; :func:`ssd_bwd_cuda` also refuses tensor
subclasses and tensors off the card.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Tuple

import torch

from .. import graphs
from . import _build
from .ssd_scan import MAX_SMEM, _chunk_len, _round16

# The kernels' block: 8 warps (two warpgroups in the chunk pass); chunks
# of at most 128 rows, P and N up to 128 (their accumulators); the walks'
# bf16 staging rows padded by 8; the chunk pass's ring of per-head loads
# has two stages.  The wrapper takes chunks up to 256, split into
# sub-chunks of at least 16 rows where they must be split.
_WARPS, _MAX_Q, _MAX_P, _MAX_N, _PAD, _STAGES = 8, 128, 128, 128, 8, 2
_MAX_CHUNK, _MIN_SUB = 256, 16
_LOG2E = 1.4426950408889634
# A chunk-pass CTA's set-up (loading B and C, forming C Bᵀ), counted in
# heads' work when choosing the heads a CTA takes.
_CTA_HEADS = 1


def _round64(v: int) -> int:
    return -(-v // 64) * 64


def kernel_chunk(Q: int, P: int, N: int) -> int:
    """The chunk the kernels run for a chunk of ``Q`` at head dim ``P`` and
    state dim ``N``: the largest divisor of ``Q`` that is at most 128 rows
    and whose shared memory fits (sub-chunks of one chunk give the same
    function; a chunk of 256 runs as two of 128, one of 128 at P and N
    over 64 as two of 64).  Raises ValueError where that splits the chunk
    into sub-chunks under 16 rows (a prime chunk over 128, say): each would
    be padded to 64 rows in the chunk pass and cost the walks a step."""
    k = max(d for d in range(1, min(Q, _MAX_Q) + 1)
            if Q % d == 0 and max(smem_bytes(d, P, N)) <= MAX_SMEM)
    if k < min(Q, _MIN_SUB):
        raise ValueError(
            f"the backward runs a chunk of {Q} at head dim {P} and state dim "
            f"{N} as sub-chunks of its largest divisor of at most {_MAX_Q} "
            f"rows that fits, here {k}; it takes sub-chunks of at least "
            f"{_MIN_SUB} rows: choose a chunk with such a divisor")
    return k


def smem_bytes(Q: int, P: int, N: int) -> Tuple[int, int]:
    """Dynamic shared memory of the (walk, chunk) kernels for the kernels'
    chunk ``Q``, head dim ``P`` and state dim ``N``.  Walk (each padded to
    16): two staging buffers of U ``[Q][P + 8]`` and V ``[Q][N + 8]``
    (bf16) and dt ``[Q]`` (fp32), then cum and the rows' weights ``[Q]``
    (fp32).  Chunk (each padded to 64; bf16 tiles in 64-column boxes): B
    and C ``[Q][N]``; C Bᵀ's T (T + 1) / 2 blocks of 64 x 64 with t >= s
    (T = Q / 64); x and dy ``[Q][P]``; Zᵀ ``[Q][Q]``; two ring stages of
    h and dh ``[P][N]`` and dt and cum ``[2][Q]`` (fp32), each padded to
    1024 bytes; the rows' four sums ``[4][Q]`` and the warps' column sums
    ``[8][Q]`` (fp32); one fp32 per warp; four mbarriers; 1024 bytes of
    alignment.  Mirrors ``WalkLayout`` and ``ChunkLayout`` in
    ``csrc/ssd_scan_bwd.cu``."""
    Qp, Pp, Np = _round16(Q), _round16(P), _round16(N)
    ldx, ldb = Pp + _PAD, Np + _PAD
    stage = 2 * Qp * ldx + 2 * Qp * ldb + 4 * Qp
    walk = 2 * stage + 2 * 4 * Qp
    Q64, P64, N64 = _round64(Q), _round64(P), _round64(N)
    T = Q64 // 64
    ring = _STAGES * -(-(4 * P64 * N64 + 8 * Q64) // 1024) * 1024
    chunk = (4 * Q64 * N64 + 4096 * T * (T + 1) + 4 * Q64 * P64
             + 2 * Q64 * Q64 + ring + 48 * Q64 + 4 * _WARPS + 32 + 1024)
    return walk, chunk


def plan(Bsz: int, nc: int, H: int, G: int, sms: int) -> int:
    """R, the heads of a group one chunk-pass CTA takes: the R that leaves
    the least work on the busiest SM, one CTA an SM at a time (waves of
    ``sms`` CTAs, each R heads plus its set-up), the larger R on a tie.
    At mamba2-2.7b's training shape (B 4, 8 chunks, 80 heads, G 1) that is
    R 20: 128 CTAs, one wave on 132 SMs."""
    rep = H // G
    best, best_cost = 1, None
    for R in range(1, rep + 1):
        ctas = Bsz * nc * G * -(-rep // R)
        cost = -(-ctas // sms) * (R + _CTA_HEADS)
        if best_cost is None or cost <= best_cost:
            best, best_cost = R, cost
    return best


def chunk_schedule(H: int, G: int, R: int, Q: int, P: int,
                   N: int) -> List[List[list]]:
    """For one (batch, chunk) of the kernels' chunk ``Q``: per chunk-pass
    CTA, in ``blockIdx.x`` order (group, then slice), what each of its two
    warpgroups takes: (head, 64-row tile, first and past-last column of
    dB and dC) for every head of the slice (R heads, the last slice what
    is left).  Warpgroup w takes tile w and every column, or nothing where
    the chunk has no tile w; at P and N of 128 (one tile) both take tile 0,
    warpgroup w columns 64w .. 64w + 63.  Mirrors ``slice_heads`` and the
    warpgroups' rows and columns in the source."""
    rep = H // G
    n_sl = -(-rep // R)
    T = _round64(Q) // 64
    split = _round64(P) == 128 and _round64(N) == 128
    out = []
    for x in range(G * n_sl):
        g, sl = divmod(x, n_sl)
        h0, nh = g * rep + sl * R, min(R, rep - sl * R)
        heads = range(h0, h0 + nh)
        if split:
            out.append([[(h, 0, 64 * w, 64 * w + 64) for h in heads]
                        for w in range(2)])
        else:
            out.append([[(h, w, 0, N) for h in heads] if w < T else []
                        for w in range(2)])
    return out


def flops(Bsz: int, S: int, H: int, P: int, G: int, N: int, chunk: int,
          sms: int) -> Tuple[float, float]:
    """The backward's products at one shape, in FLOPs: ``(function,
    design)``.  The function's, the least the gradients need: per head and
    chunk five state products of Q·P·N (the walks' states and state
    gradients, dh·B for dx, x·dh for dB, dy·h for dC) and two triangles
    over P (L·dy for dx, and Z = dy·xᵀ); per group and chunk three
    triangles over N (C·Bᵀ, and Z∘decay summed over the group's heads
    times C and times B), a triangle counted by its Q(Q+1)/2 pairs.  The
    design's, what the kernels issue at their chunk, P and N padded (to 16
    in the walks, 64 in the chunk pass), triangles by whole 64 x 64 blocks:
    per head the walks' two state products, four in the chunk pass (B dhᵀ,
    C hᵀ, x dh, dy h) and four triangles (L'·dy and Z over P, Zᵀ·C and Z·B
    over N); C·Bᵀ once per CTA of R heads, R as the wrapper plans it on
    ``sms`` SMs (:func:`plan`)."""
    Q = _chunk_len(S, chunk)
    nc = S // Q
    pairs = Q * (Q + 1) // 2
    function = 2.0 * Bsz * nc * (H * (5 * Q * P * N + 2 * pairs * P)
                                 + G * 3 * pairs * N)
    Qk = kernel_chunk(Q, P, N)
    nck = S // Qk
    Qp, Pp, Np = _round16(Qk), _round16(P), _round16(N)
    Q64, P64, N64 = _round64(Qk), _round64(P), _round64(N)
    T = Q64 // 64
    blocks = 4096 * T * (T + 1) // 2
    R = plan(Bsz, nck, H, G, sms)
    ctas = Bsz * nck * G * -(-(H // G) // R)
    design = 2.0 * (Bsz * H * nck * (2 * Qp * Pp * Np + 4 * Q64 * P64 * N64
                                      + blocks * 2 * (P64 + N64))
                    + ctas * blocks * N64)
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
    formula).  ``dtype`` bfloat16 follows the kernels, for the floor of the
    card's check: their chunk (:func:`kernel_chunk`); cum in log2 units
    summed in their order; each product's operands rounded to bf16 as they
    round them (the states and state gradients, x and dy scaled by their
    rows' weights, C·Bᵀ, then L from it, and Z); <dh, h_c> from the bf16
    states.  Returns ``(dx, ddt, dA, dB, dC, dh0)`` in the dtypes of x,
    dt, A, B, C and fp32; ``dh0`` is None without ``initial_state``."""
    def rnd(t):
        return t.to(dtype).float()

    Bsz, S, H, P = x.shape
    G, N = Bmat.shape[2], Bmat.shape[3]
    rep = H // G
    Q = _chunk_len(S, chunk)
    if dtype != torch.float32:
        Q = kernel_chunk(Q, P, N)
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
    Hs = rnd(torch.stack(states[:nc], dim=1))            # [B,nc,H,P,N]

    # The gradients of the states leaving each chunk, by a reverse walk.
    dstate_in = torch.einsum("bcqhp,bcqhn->bchpn",
                             rnd(dyf * ecum[..., None]), Ch)
    dh = (dstate.float() if dstate is not None
          else x.new_zeros((Bsz, H, P, N), dtype=torch.float32))
    dhs = [None] * nc
    for c in reversed(range(nc)):
        dhs[c] = dh
        dh = dh * ex(total[:, c])[..., None, None] + dstate_in[:, c]
    DH = rnd(torch.stack(dhs, dim=1))                    # [B,nc,H,P,N]

    # Within each chunk: decay[t, s] = exp(cum_t - cum_s) for s <= t, masked
    # inside the exponent (a positive difference would overflow to inf).
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # [B,nc,t,s,H]
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    decay = ex(diff.masked_fill(~tri[None, None, :, :, None],
                                       float("-inf")))
    CB = rnd(torch.einsum("bcthn,bcshn->bctsh", Ch, Bh))
    L = rnd(CB * decay)
    Z = torch.einsum("bcthp,bcshp->bctsh", dyf, xf) * decay \
        * dtf[:, :, None, :, :]                           # diagonal included
    Zr = rnd(Z)

    # dx and the direct part of ddt; F_s, the part of x_s . u_s that comes
    # from dh (times dt_s), on its own.
    u_dh = ex(total[:, :, None, :] - cum)[..., None] \
        * torch.einsum("bcshn,bchpn->bcshp", Bh, DH)
    f = dtf * (xf * u_dh).sum(-1)
    u = u_dh + torch.einsum("bctsh,bcthp->bcshp", L, dyf)
    dx = dtf[..., None] * u
    g = (xf * u).sum(-1)

    # Per head: dB_s = sum_{t>=s} Z[t,s] C_t + w_s x_s dh and
    # dC_t = sum_{s<=t} Z[t,s] B_s + exp(cum_t) dy_t h_c.
    dBh = torch.einsum("bctsh,bcthn->bcshn", Zr, Ch) + torch.einsum(
        "bcshp,bchpn->bcshn", rnd(xf * w[..., None]), DH)
    dCh = torch.einsum("bctsh,bcshn->bcthn", Zr, Bh) + torch.einsum(
        "bcthp,bchpn->bcthn", rnd(dyf * ecum[..., None]), Hs)

    # The gradient of cum, summed from each row to the chunk's end (da,
    # the gradient of dt_s A), with no two terms that cancel: off the
    # diagonal, C_t . dC'_t and B_s . dB'_s are the row and column sums of
    # Z o C Bᵀ, the h_c term is exp(cum_t) dy_t . (C_t h_cᵀ), and the F
    # terms of rows t >= s cancel against the total's, leaving those of
    # rows t < s.
    eye = torch.eye(Q, dtype=torch.bool, device=x.device)
    ZL = (Z * CB).masked_fill(eye[None, None, :, :, None], 0.0)
    hv = ecum * (dyf * torch.einsum("bcthn,bchpn->bcthp", Ch, Hs)).sum(-1)
    dcum = ZL.sum(3) - ZL.sum(2) + hv                    # [B,nc,Q,H]
    da = torch.flip(torch.cumsum(torch.flip(dcum, (2,)), 2), (2,)) \
        + (ex(total) * (DH * Hs).sum((-1, -2)))[:, :, None] \
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
    lib.ssd_scan_bwd.argtypes = [p] * 20 + [i] * 9 + [p]
    lib.ssd_scan_bwd.restype = ctypes.c_int
    lib.ssd_scan_bwd_smem_bytes.argtypes = [i, i, i, i]
    lib.ssd_scan_bwd_smem_bytes.restype = ctypes.c_long
    return lib


def _check(x, dt, A, Bmat, Cmat, dy, dstate, initial_state, chunk: int,
           real: bool) -> int:
    """Raise on anything the kernels do not take (``real`` also checks
    the device); returns the chunk the kernels run."""
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
        _build.check_tensor(name, t, dtype, shape, x.device, real)
    if G == 0 or H % G:
        raise ValueError(f"n_heads {H} is not a multiple of n_groups {G}")
    Q = _chunk_len(S, chunk)
    if Q > _MAX_CHUNK or not 0 < P <= _MAX_P or not 0 < N <= _MAX_N:
        raise ValueError(f"the backward takes chunks of at most "
                         f"{_MAX_CHUNK}, head dims 1..{_MAX_P} and state dims "
                         f"1..{_MAX_N}, got chunk {Q}, P {P}, N {N}")
    Q = kernel_chunk(Q, P, N)
    smem = max(smem_bytes(Q, P, N))
    if smem > MAX_SMEM:
        raise ValueError(f"chunk {Q}, head dim {P}, state dim {N} need "
                         f"{smem} bytes of shared memory (at most "
                         f"{MAX_SMEM})")
    return Q


def _allocate(x, dt, A, Bmat, Cmat, initial_state, Q: int, sms: int):
    """The gradients (dh0 empty without an initial state) and, where the
    launch has work, its scratch and R (:func:`plan` on ``sms`` SMs):
    ``(grads, scratch or None, R)``.  Scratch: the states entering each
    chunk and the gradients of the states leaving it (bf16 [P, N], rows
    padded to 64 and columns to 16; the walks write rows up to P padded
    to 16, the rest stays zeros), each chunk's dt and cum (fp32, rows
    padded to 64), one dB and dC partial per head slice and dA per
    (batch, head, chunk); summed in a fixed order, no atomics."""
    Bsz, S, H, P = x.shape
    G, N = Bmat.shape[2], Bmat.shape[3]
    grads = (torch.empty_like(x), torch.empty_like(dt), torch.empty_like(A),
             torch.empty_like(Bmat), torch.empty_like(Cmat),
             x.new_empty((Bsz, H, P, N), dtype=torch.float32)
             if initial_state is not None else _build.nothing(x))
    if Bsz == 0 or H == 0:
        return grads, None, 0
    nc = S // Q
    R = plan(Bsz, nc, H, G, sms)
    n_sl = -(-(H // G) // R)
    f32 = dict(dtype=torch.float32)
    P64, Pp, Np = _round64(P), _round16(P), _round16(N)
    alloc = x.new_zeros if P64 > Pp else x.new_empty
    scratch = (alloc((Bsz, H, nc, P64, Np)),                  # states
               alloc((Bsz, H, nc, P64, Np)),                  # dstates
               x.new_empty((Bsz, H, nc, 2, _round64(Q)), **f32),
               x.new_empty((Bsz, S, G * n_sl, N), **f32),     # part_b
               x.new_empty((Bsz, S, G * n_sl, N), **f32),     # part_c
               x.new_empty((Bsz, H, nc), **f32))              # part_a
    return grads, scratch, R


def _launch(x, dt, A, Bmat, Cmat, dy, dstate, initial_state, chunk: int):
    """The op's CUDA implementation: check, allocate, launch."""
    Q = _check(x, dt, A, Bmat, Cmat, dy, dstate, initial_state, chunk, True)
    lib = _lib()
    dev = x.device
    (dx, ddt, dA, dB, dC, dh0), scratch, R = _allocate(
        x, dt, A, Bmat, Cmat, initial_state, Q,
        torch.cuda.get_device_properties(dev).multi_processor_count)
    if scratch is None:
        for t in (dA, dB, dC):
            t.zero_()
        return dx, ddt, dA, dB, dC, dh0
    states, dstates, dtc, part_b, part_c, part_a = scratch
    Bsz, S, H, P = x.shape
    G, N = Bmat.shape[2], Bmat.shape[3]

    def ptr(t):
        return t.data_ptr() if t is not None else None

    status = lib.ssd_scan_bwd(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bmat.data_ptr(),
        Cmat.data_ptr(), dy.data_ptr(), ptr(dstate), ptr(initial_state),
        states.data_ptr(), dstates.data_ptr(), dtc.data_ptr(),
        part_b.data_ptr(), part_c.data_ptr(), part_a.data_ptr(),
        dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(),
        dC.data_ptr(), ptr(dh0 if initial_state is not None else None),
        Bsz, S, H, P, G, N, Q, R, dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, status, "ssd_scan_bwd")
    graphs.count(ssd_bwd_cuda)
    return dx, ddt, dA, dB, dC, dh0


def _plain(x, dt, A, Bmat, Cmat, dy, dstate, initial_state, chunk: int):
    """The op's CPU implementation: the plain formula (float32), laid out
    as the kernel lays its outputs."""
    grads = ssd_bwd_plain(x, dt, A, Bmat, Cmat, dy, dstate, chunk=chunk,
                          initial_state=initial_state)
    return tuple(_build.nothing(x) if g is None
                 else g.clone(memory_format=torch.contiguous_format)
                 for g in grads)


def _fake(x, dt, A, Bmat, Cmat, dy, dstate, initial_state, chunk: int):
    Q = _check(x, dt, A, Bmat, Cmat, dy, dstate, initial_state, chunk, False)
    grads, scratch, _ = _allocate(x, dt, A, Bmat, Cmat, initial_state, Q,
                                  _build.H100_SMS)
    _build.fake_scratch(*(scratch or ()))
    return grads


def _flops(x_shape, dt_shape, A_shape, B_shape, C_shape, dy_shape,
           dstate_shape, h0_shape, chunk, out_shape=None) -> int:
    Bsz, S, H, P = x_shape
    G, N = B_shape[2], B_shape[3]
    return int(flops(Bsz, S, H, P, G, N, chunk, _build.H100_SMS)[1])


OP = _build.define_op(
    "ssd_scan_bwd",
    "(Tensor x, Tensor dt, Tensor A, Tensor B, Tensor C, Tensor dy, "
    "Tensor? dstate, Tensor? initial_state, int chunk) "
    "-> (Tensor, Tensor, Tensor, Tensor, Tensor, Tensor)",
    cuda=_launch, cpu=_plain, fake=_fake, flops=_flops)


def ssd_bwd_op(x, dt, A, Bmat, Cmat, dy, dstate=None, *, chunk: int = 128,
               initial_state: Optional[torch.Tensor] = None) -> tuple:
    """The op: the kernels for CUDA tensors, the fake implementation for
    fake ones.  Returns what :func:`ssd_bwd_cuda` returns."""
    grads = OP(x, dt, A, Bmat, Cmat, dy, dstate, initial_state, int(chunk))
    return grads[:5] + ((grads[5] if initial_state is not None else None),)


def ssd_bwd_cuda(x, dt, A, Bmat, Cmat, dy, dstate=None, *, chunk: int = 128,
                 initial_state: Optional[torch.Tensor] = None) -> tuple:
    """Launch the CUDA kernel.  Returns ``(dx, ddt, dA, dB, dC, dh0)``:
    bf16, fp32, fp32, bf16, bf16 and fp32 (None without
    ``initial_state``).  ``dstate`` None counts as zeros."""
    _build.check_plain("ssd_bwd_cuda", x, dt, A, Bmat, Cmat, dy, dstate,
                        initial_state)
    if x.device.type != "cuda":
        raise ValueError(f"x must be a CUDA tensor, got {x.device}")
    return ssd_bwd_op(x, dt, A, Bmat, Cmat, dy, dstate, chunk=chunk,
                      initial_state=initial_state)


#: Launches of the CUDA kernel since the last reset (``launches = 0``).
ssd_bwd_cuda.launches = 0
