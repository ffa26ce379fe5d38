"""RG-LRU scan backward: the CUDA kernel's wrapper and its plain version.

The kernel (``csrc/rglru_scan_bwd.cu``) replaces the backward of the JAX
package's ``repro.kernels.ops.rglru`` (XLA autodiff of its two-level scan
under ``jax.checkpoint``; no Pallas kernel exists for it: the Pallas
forward ``rglru_pallas`` has no VJP).  Given the forward's inputs, the
cotangent ``dh`` of h and (optionally) ``dstate`` of the final state, it
returns ``(dx, d gate_a, d gate_i, d log_a, d initial_state)``.  Its
wrapper takes CUDA tensors in the forward's layout (x and dh ``[B, S, C]``
bf16, the gates ``[B, S, C]`` fp32, ``log_a`` ``[C]`` fp32, the initial
state and dstate ``[B, C]`` fp32) and the fp32 states entering each chunk
that the forward kernel returns with ``entering=True``
(:func:`repro_torch.kernels.rglru_scan.rglru_cuda`), checks them,
allocates the gradients and the kernel's scratch and launches on
PyTorch's current stream.  It
raises on anything the kernel does not take; it never falls back to the
plain version.  One call of the wrapper is one launch of the kernel (its
two CUDA kernels: the scan, the sum of d log_a over the batch).

The math, per (batch b, channel c), with lambda = ``log_a[c]``:

- forward: L_t = c lambda r_t, a_t = exp(L_t), e_t = exp(2 L_t),
  beta_t = sqrt(max(1 - e_t, 0)), h_t = a_t h_{t-1} + beta_t i_t x_t,
  h_0 the initial state or 0;
- g_T = dh_T + dh_fin and g_t = dh_t + a_{t+1} g_{t+1}: a reverse affine
  scan;
- dx_t = g_t beta_t i_t (in x's dtype), d gate_i_t = g_t beta_t x_t;
- dL_t = g_t (a_t h_{t-1} - (e_t / beta_t) i_t x_t): the derivative of
  a_t is a_t, that of beta_t is -e_t / beta_t (e_t the forward's own
  exp(2 L_t), a_t^2 in exact arithmetic);
- d gate_a_t = c lambda dL_t, d log_a = sum_{b,t} c r_t dL_t;
- d initial_state = a_1 g_1, where an initial state was given.

Where 1 - e_t <= 0 (beta_t = 0: L_t = 0 in fp32, a gate r_t that rounds
L to 0, or an input outside the model's range) the square root has no
derivative, and autodiff in both packages gives inf or NaN there.  The
kernel and the plain version take the derivative of beta_t as 0 at such
a step: its term of dL_t is dropped, and every gradient stays finite.

The kernel's launch geometry, mirrored here from the source for the
tests: one CTA per (batch, tile of ``TILE`` channels) walks its chunks of
``CHUNK`` steps once, from the last, starting each from the forward's
entering state, its ``WARPS`` warps taking sub-segments of ``CHUNK //
WARPS`` steps; each chunk's inputs arrive in one of ``STAGES`` shared-
memory buffers, and its gradients leave from the same buffer.

The launch is the operator ``torch.ops.repro_torch.rglru_scan_bwd`` (x,
gate_a, gate_i, log_a, dh, dstate or None, entering, initial_state or
None, c) -> (dx, d gate_a, d gate_i, d log_a, d initial_state), the last
empty without an initial state: its CUDA implementation launches, its
fake one allocates the gradients and the scratch (each batch row's d
log_a; the grid needs no device query), its flop formula counts no
products.  :func:`rglru_bwd_op` calls it; :func:`rglru_bwd_cuda` also
refuses tensor subclasses and tensors off the card.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from .. import graphs
from . import _build

# csrc/rglru_scan_bwd.cu: T, TILE, WARPS (the forward's) and STAGES.
CHUNK, TILE, WARPS, STAGES = 64, 32, 8, 2


def rglru_bwd_plain(x, gate_a, gate_i, log_a, dh, dstate=None, *,
                    initial_state: Optional[torch.Tensor] = None,
                    c: float = 8.0) -> tuple:
    """The gradients above as a sequential float32 loop: the forward
    recomputed step by step, then the reverse scan.  Returns ``(dx,
    d gate_a, d gate_i, d log_a, d initial_state or None)`` in the dtypes
    of x, the gates, ``log_a`` and float32."""
    B, S, C = x.shape
    xf, rf, if_ = x.float(), gate_a.float(), gate_i.float()
    la = c * log_a.float()
    dhf = dh.float()
    h = (initial_state.float() if initial_state is not None
         else xf.new_zeros((B, C)))
    L = la[None, None] * rf
    a = torch.exp(L)
    e2 = torch.exp(2.0 * L)
    u = 1.0 - e2
    beta = torch.sqrt(torch.clamp(u, min=0.0))
    # d beta / dL = -e / beta where 1 - e > 0, else 0 (the rule above)
    dbeta = torch.where(u > 0, -e2 / torch.where(u > 0, beta, 1.0), 0.0)
    ix = if_ * xf
    hprev = []
    for t in range(S):
        hprev.append(h)
        h = a[:, t] * h + beta[:, t] * ix[:, t]
    carry = (dstate.float() if dstate is not None
             else xf.new_zeros((B, C)))
    dx = torch.empty_like(xf)
    dga = torch.empty_like(xf)
    dgi = torch.empty_like(xf)
    dla = xf.new_zeros((B, C))
    for t in range(S - 1, -1, -1):
        g = dhf[:, t] + carry
        dx[:, t] = g * beta[:, t] * if_[:, t]
        dgi[:, t] = g * beta[:, t] * xf[:, t]
        dL = g * (a[:, t] * hprev[t] + dbeta[:, t] * ix[:, t])
        dga[:, t] = la[None] * dL
        dla += rf[:, t] * dL
        carry = a[:, t] * g
    dlog_a = c * dla.sum(0)
    return (dx.to(x.dtype), dga.to(gate_a.dtype), dgi.to(gate_i.dtype),
            dlog_a.to(log_a.dtype),
            carry if initial_state is not None else None)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("rglru_scan_bwd")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.rglru_scan_bwd.argtypes = [p] * 13 + [i, i, i, ctypes.c_float, i, p]
    lib.rglru_scan_bwd.restype = ctypes.c_int
    lib.rglru_scan_bwd_occupancy.argtypes = [i, ctypes.POINTER(i)]
    lib.rglru_scan_bwd_occupancy.restype = ctypes.c_int
    return lib


def occupancy(tma: bool = True) -> int:
    """The scan kernel's CTAs an SM holds at once (CUDA's occupancy
    calculator), of its TMA instantiation or the other."""
    lib, blocks = _lib(), ctypes.c_int(0)
    _build.check(lib, lib.rglru_scan_bwd_occupancy(int(tma),
                                                    ctypes.byref(blocks)),
                 "rglru_scan_bwd_occupancy")
    return blocks.value


def _check(x, gate_a, gate_i, log_a, dh, dstate, entering, initial_state,
           real: bool) -> None:
    """Raise on anything the kernel does not take (``real`` also checks
    the device)."""
    if x.dim() != 3:
        raise ValueError("x must be [B, S, C]")
    B, S, C = x.shape
    dev = x.device
    if real and dev.type != "cuda":
        raise ValueError(f"x must be a CUDA tensor, got {dev}")
    args = [("x", x, torch.bfloat16, (B, S, C)),
            ("gate_a", gate_a, torch.float32, (B, S, C)),
            ("gate_i", gate_i, torch.float32, (B, S, C)),
            ("log_a", log_a, torch.float32, (C,)),
            ("dh", dh, torch.bfloat16, (B, S, C)),
            ("entering", entering, torch.float32, (B, -(-S // CHUNK), C))]
    if dstate is not None:
        args.append(("dstate", dstate, torch.float32, (B, C)))
    if initial_state is not None:
        args.append(("initial_state", initial_state, torch.float32, (B, C)))
    for name, t, dtype, shape in args:
        _build.check_tensor(name, t, dtype, shape, dev, real)
    if S * C >= 2 ** 31:
        raise ValueError(f"S * C = {S * C} must be under 2^31 (the kernel's "
                         f"offsets within a batch row are 32-bit)")


def _allocate(x, gate_a, gate_i, log_a, initial_state):
    """The gradients (d initial_state empty without one) and each batch
    row's d log_a (scratch; None where the launch has nothing to do)."""
    B, S, C = x.shape
    grads = (torch.empty_like(x), torch.empty_like(gate_a),
             torch.empty_like(gate_i), torch.empty_like(log_a),
             x.new_empty((B, C), dtype=torch.float32)
             if initial_state is not None else _build.nothing(x))
    if B == 0 or C == 0:
        return grads, None
    return grads, x.new_empty((B, C), dtype=torch.float32)


def _launch(x, gate_a, gate_i, log_a, dh, dstate, entering, initial_state,
            c: float):
    """The op's CUDA implementation: check, allocate, launch."""
    _check(x, gate_a, gate_i, log_a, dh, dstate, entering, initial_state,
           True)
    (dx, dga, dgi, dla, dh0), partial = _allocate(x, gate_a, gate_i, log_a,
                                                  initial_state)
    if partial is None:
        return dx, dga, dgi, dla.zero_(), dh0
    B, S, C = x.shape
    dev = x.device

    def ptr(t):
        return t.data_ptr() if t is not None else None

    lib = _lib()
    status = lib.rglru_scan_bwd(
        ptr(x), ptr(gate_a), ptr(gate_i), ptr(log_a), ptr(dh), ptr(dstate),
        ptr(entering), ptr(dx), ptr(dga), ptr(dgi), ptr(dla),
        ptr(dh0 if initial_state is not None else None),
        ptr(partial), B, S, C, float(c), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, status, "rglru_scan_bwd")
    graphs.count(rglru_bwd_cuda)
    return dx, dga, dgi, dla, dh0


def _plain(x, gate_a, gate_i, log_a, dh, dstate, entering, initial_state,
           c: float):
    """The op's CPU implementation: the plain formula (float32; it
    recomputes the states, so ``entering`` is not read), laid out as the
    kernel lays its outputs."""
    grads = rglru_bwd_plain(x, gate_a, gate_i, log_a, dh, dstate,
                            initial_state=initial_state, c=c)
    return tuple(_build.nothing(x) if g is None
                 else g.clone(memory_format=torch.contiguous_format)
                 for g in grads)


def _fake(x, gate_a, gate_i, log_a, dh, dstate, entering, initial_state,
          c: float):
    _check(x, gate_a, gate_i, log_a, dh, dstate, entering, initial_state,
           False)
    grads, partial = _allocate(x, gate_a, gate_i, log_a, initial_state)
    _build.fake_scratch(partial)
    return grads


def flops(*shapes, out_shape=None) -> int:
    """No products: the reverse scan is elementwise."""
    return 0


OP = _build.define_op(
    "rglru_scan_bwd",
    "(Tensor x, Tensor gate_a, Tensor gate_i, Tensor log_a, Tensor dh, "
    "Tensor? dstate, Tensor entering, Tensor? initial_state, float c) "
    "-> (Tensor, Tensor, Tensor, Tensor, Tensor)",
    cuda=_launch, cpu=_plain, fake=_fake, flops=flops)


def rglru_bwd_op(x, gate_a, gate_i, log_a, dh, dstate=None, *,
                 entering: torch.Tensor,
                 initial_state: Optional[torch.Tensor] = None,
                 c: float = 8.0) -> Tuple:
    """The op: the kernel for CUDA tensors, the fake implementation for
    fake ones.  Returns what :func:`rglru_bwd_cuda` returns."""
    grads = OP(x, gate_a, gate_i, log_a, dh, dstate, entering,
               initial_state, float(c))
    return grads[:4] + ((grads[4] if initial_state is not None else None),)


def rglru_bwd_cuda(x, gate_a, gate_i, log_a, dh, dstate=None, *,
                   entering: torch.Tensor,
                   initial_state: Optional[torch.Tensor] = None,
                   c: float = 8.0) -> Tuple:
    """Launch the CUDA kernel.  ``entering`` is the forward's fp32 state
    entering each chunk (``rglru_cuda(..., entering=True)`` on the same
    inputs and initial state).  Returns ``(dx`` bf16, ``d gate_a``, ``d
    gate_i``, ``d log_a`` and ``d initial_state`` fp32, the last None
    without an initial state)."""
    _build.check_plain("rglru_bwd_cuda", x, gate_a, gate_i, log_a, dh, dstate,
                        entering, initial_state)
    if x.dim() != 3:
        raise ValueError("x must be [B, S, C]")
    if x.device.type != "cuda":
        raise ValueError(f"x must be a CUDA tensor, got {x.device}")
    return rglru_bwd_op(x, gate_a, gate_i, log_a, dh, dstate,
                        entering=entering, initial_state=initial_state, c=c)


#: Launches of the CUDA kernel since the last reset (``launches = 0``).
rglru_bwd_cuda.launches = 0
