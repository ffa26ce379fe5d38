"""RG-LRU scan: the CUDA kernel's wrapper and its plain version.

The kernel (``csrc/rglru_scan.cu``) replaces the Pallas TPU kernel
``repro.kernels.rglru_scan.rglru_pallas``.  Its wrapper takes CUDA tensors
in the JAX package's layout -- x ``[B, S, C]`` bf16, the gates ``[B, S,
C]`` fp32 (the mix the RG-LRU block feeds it), ``log_a`` ``[C]`` fp32 and
an optional fp32 initial state ``[B, C]`` -- checks them, allocates h
(bf16) and the final state (fp32) and launches on PyTorch's current
stream.  Unlike the Pallas kernel it takes ``initial_state`` itself.  It
raises on anything the kernel does not take; it never falls back.

With ``entering=True`` both versions also return the fp32 state entering
each ``CHUNK``-step chunk, ``[B, ceil(S / CHUNK), C]`` (chunk 0's is the
initial state, or zeros): the backward kernel reads it instead of
rebuilding it.  Asking for it changes no bit of h or the final state.

The kernel's launch geometry, mirrored here from the source for the
tests: a CTA per (batch, tile of ``TILE`` channels) walks chunks of
``CHUNK`` steps, its ``WARPS`` warps scanning sub-segments of
``CHUNK // WARPS`` steps.

The launch is the operator ``torch.ops.repro_torch.rglru_scan`` (x,
gate_a, gate_i, log_a, initial_state or None, c, entering) -> (h, state,
entering states), the last empty without ``entering``: its CUDA
implementation launches, its fake one allocates the same outputs (the
kernel needs no scratch), its flop formula counts no products (the
recurrence is elementwise, as the flop counter counts the plain version).
:func:`rglru_op` calls it; :func:`rglru_cuda` also refuses tensor
subclasses and tensors off the card.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from .. import graphs
from . import _build, ref


# csrc/rglru_scan.cu: T, TILE, WARPS.
CHUNK, TILE, WARPS = 64, 32, 8


def rglru_plain(x, gate_a, gate_i, log_a, *,
                initial_state: Optional[torch.Tensor] = None,
                c: float = 8.0, entering: bool = False) -> tuple:
    """The same recurrence as a sequential float32 loop
    (:func:`ref.rglru_scan`).  Returns (h in x's dtype, final state fp32)
    and, with ``entering``, the fp32 state entering each chunk: the loop
    runs chunk by chunk, each chunk's final state the next one's initial
    state, the same steps in the same order."""
    if not entering:
        return ref.rglru_scan(x, gate_a, gate_i, log_a, initial_state, c)
    B, S, C = x.shape
    state = (initial_state.float() if initial_state is not None
             else torch.zeros((B, C), device=x.device))
    hs, states = [], []
    for t in range(0, S, CHUNK):
        states.append(state)
        piece = slice(t, t + CHUNK)
        h, state = ref.rglru_scan(x[:, piece], gate_a[:, piece],
                                  gate_i[:, piece], log_a, state, c)
        hs.append(h)
    if not hs:
        return (x.new_empty((B, 0, C)), state,
                torch.empty((B, 0, C), device=x.device))
    return torch.cat(hs, 1), state, torch.stack(states, 1)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("rglru_scan")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.rglru_scan_fwd.argtypes = [p] * 8 + [i, i, i, ctypes.c_float, i, p]
    lib.rglru_scan_fwd.restype = ctypes.c_int
    return lib


def _check(x, gate_a, gate_i, log_a, initial_state, real: bool) -> None:
    """Raise on anything the kernel does not take (``real`` also checks
    the device)."""
    if x.dim() != 3:
        raise ValueError("x must be [B, S, C]")
    B, S, C = x.shape
    args = [("x", x, torch.bfloat16, (B, S, C)),
            ("gate_a", gate_a, torch.float32, (B, S, C)),
            ("gate_i", gate_i, torch.float32, (B, S, C)),
            ("log_a", log_a, torch.float32, (C,))]
    if initial_state is not None:
        args.append(("initial_state", initial_state, torch.float32, (B, C)))
    for name, t, dtype, shape in args:
        _build.check_tensor(name, t, dtype, shape, x.device, real)


def _outputs(x, entering: bool):
    B, S, C = x.shape
    return (torch.empty_like(x),
            x.new_empty((B, C), dtype=torch.float32),
            x.new_empty((B, -(-S // CHUNK), C), dtype=torch.float32)
            if entering else _build.nothing(x))


def _launch(x, gate_a, gate_i, log_a, initial_state, c: float,
            entering: bool):
    """The op's CUDA implementation: check, allocate, launch."""
    _check(x, gate_a, gate_i, log_a, initial_state, True)
    B, S, C = x.shape
    h, state, states = _outputs(x, entering)
    if B == 0 or C == 0:
        return h, state, states
    lib = _lib()
    status = lib.rglru_scan_fwd(
        x.data_ptr(), gate_a.data_ptr(), gate_i.data_ptr(), log_a.data_ptr(),
        initial_state.data_ptr() if initial_state is not None else None,
        h.data_ptr(), state.data_ptr(),
        states.data_ptr() if entering else None, B, S, C, float(c),
        x.device.index, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, status, "rglru_scan_fwd")
    graphs.count(rglru_cuda)
    return h, state, states


def _plain(x, gate_a, gate_i, log_a, initial_state, c: float,
           entering: bool):
    """The op's CPU implementation: the plain version, laid out as the
    kernel lays its outputs."""
    got = rglru_plain(x, gate_a, gate_i, log_a, initial_state=initial_state,
                      c=c, entering=entering)
    if not entering:
        got = (*got, _build.nothing(x))
    return tuple(t.clone(memory_format=torch.contiguous_format)
                 for t in got)


def _fake(x, gate_a, gate_i, log_a, initial_state, c: float,
          entering: bool):
    _check(x, gate_a, gate_i, log_a, initial_state, False)
    return _outputs(x, entering)


def flops(*shapes, out_shape=None) -> int:
    """No products: the recurrence is elementwise."""
    return 0


OP = _build.define_op(
    "rglru_scan",
    "(Tensor x, Tensor gate_a, Tensor gate_i, Tensor log_a, "
    "Tensor? initial_state, float c, bool entering) "
    "-> (Tensor, Tensor, Tensor)",
    cuda=_launch, cpu=_plain, fake=_fake, flops=flops)


def rglru_op(x, gate_a, gate_i, log_a, *,
             initial_state: Optional[torch.Tensor] = None,
             c: float = 8.0, entering: bool = False) -> tuple:
    """The op: the kernel for CUDA tensors, the fake implementation for
    fake ones.  Returns what :func:`rglru_cuda` returns."""
    h, state, states = OP(x, gate_a, gate_i, log_a, initial_state, float(c),
                          entering)
    return (h, state, states) if entering else (h, state)


def rglru_cuda(x, gate_a, gate_i, log_a, *,
               initial_state: Optional[torch.Tensor] = None,
               c: float = 8.0, entering: bool = False) -> tuple:
    """Launch the CUDA kernel.  Returns (h ``[B, S, C]`` bf16, final state
    ``[B, C]`` fp32) and, with ``entering``, the fp32 state entering each
    chunk ``[B, ceil(S / CHUNK), C]``."""
    _build.check_plain("rglru_cuda", x, gate_a, gate_i, log_a, initial_state)
    if x.dim() != 3:
        raise ValueError("x must be [B, S, C]")
    if x.device.type != "cuda":
        raise ValueError(f"x must be a CUDA tensor, got {x.device}")
    return rglru_op(x, gate_a, gate_i, log_a, initial_state=initial_state,
                    c=c, entering=entering)


#: Launches of the CUDA kernel since the last reset (``launches = 0``).
rglru_cuda.launches = 0
