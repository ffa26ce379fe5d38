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
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

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


def rglru_cuda(x, gate_a, gate_i, log_a, *,
               initial_state: Optional[torch.Tensor] = None,
               c: float = 8.0, entering: bool = False) -> tuple:
    """Launch the CUDA kernel.  Returns (h ``[B, S, C]`` bf16, final state
    ``[B, C]`` fp32) and, with ``entering``, the fp32 state entering each
    chunk ``[B, ceil(S / CHUNK), C]``."""
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
        _build.check_tensor(name, t, dtype, shape, x.device)
    h = torch.empty_like(x)
    state = torch.empty((B, C), dtype=torch.float32, device=x.device)
    states = torch.empty((B, -(-S // CHUNK), C), dtype=torch.float32,
                         device=x.device) if entering else None
    out = (h, state, states) if entering else (h, state)
    if B == 0 or C == 0:
        return out
    lib = _lib()
    status = lib.rglru_scan_fwd(
        x.data_ptr(), gate_a.data_ptr(), gate_i.data_ptr(), log_a.data_ptr(),
        initial_state.data_ptr() if initial_state is not None else None,
        h.data_ptr(), state.data_ptr(),
        states.data_ptr() if entering else None, B, S, C, float(c),
        x.device.index, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, status, "rglru_scan_fwd")
    rglru_cuda.launches += 1
    return out


#: Launches of the CUDA kernel since the last reset (``launches = 0``).
rglru_cuda.launches = 0
