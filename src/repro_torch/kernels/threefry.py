"""jax.random's threefry streams on the card: the CUDA kernel's wrapper and
its plain version.

The kernel (``csrc/threefry.cu``) replaces no Pallas kernel: the JAX
package leaves its seeded draws to XLA.  One launch fills a contiguous
tensor with elements ``[offset, offset + numel)`` of a stream of
:mod:`repro_torch.prng`: the raw 32-bit bits (``"bits"``, int32 out), a
uniform in ``[lo, hi)`` or a normal (``"normal"``), times ``scale`` (or
divided by it, ``divide``), stored in the output's dtype (float32 or
bf16).  ``bf16_math`` draws what ``jax.random.uniform`` / ``normal`` draw
in bf16 (8-bit bits, bf16 rounding after each step) and scales in bf16.

:func:`draw` is the entry point: the kernel for a CUDA tensor, the plain
version (:func:`threefry_plain`, in chunks of :data:`CHUNK` elements) for
a CPU one; nothing falls back.  The launch is the operator
``torch.ops.repro_torch.threefry``, which writes into its first argument:
its CUDA implementation launches, its CPU one runs the plain version, its
fake one does nothing (the output exists already) and its flop formula
counts no products.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import intra_op_threads, prng
from . import _build

DISTS = {"bits": 0, "uniform": 1, "normal": 2}
#: Elements the plain version draws at once: its int32, float32 and
#: float64 transients then stay in a CPU's cache (``tools/plain_draw_time.py``
#: times 2**14 to 2**19 at once).
CHUNK = 1 << 16


def _params(dist: str, lo: float, hi: float, scale: float, divide: bool,
            bf16_math: bool):
    """(lo, hi, scale) rounded to the draw's dtype, the uniform's bounds
    those of ``jax.random.normal`` for a normal."""
    rnd = prng.round_bf16 if bf16_math else prng.round_f32
    if dist == "normal":
        lo, hi = -1.0 + (2.0 ** -8 if bf16_math else 2.0 ** -24), 1.0
    if bf16_math and divide:
        raise ValueError("bf16_math draws multiply by their scale")
    return rnd(lo), rnd(hi), rnd(scale)


def threefry_plain(key: torch.Tensor, numel: int, dist: str = "normal", *,
                   lo: float = 0.0, hi: float = 1.0, scale: float = 1.0,
                   divide: bool = False, bf16_math: bool = False,
                   offset: int = 0, device=None) -> torch.Tensor:
    """The kernel's function as plain PyTorch on ``device``: a flat tensor
    of ``numel`` elements (int32 bits, as the kernel stores them, or
    float32 values; bf16-exact values with ``bf16_math``)."""
    if dist == "bits":
        return prng.bits32(key, numel, offset=offset, device=device)
    if dist not in DISTS:
        raise ValueError(f"unknown distribution {dist!r}")
    dtype = torch.bfloat16 if bf16_math else torch.float32
    _, _, s = _params(dist, lo, hi, scale, divide, bf16_math)
    if dist == "normal":
        v = prng.normal(key, numel, dtype, offset=offset, device=device)
    else:
        v = prng.uniform(key, numel, dtype, lo, hi, offset=offset,
                         device=device)
    if bf16_math:
        return (v * s).float()
    return (v.double() / s).float() if divide else v * s


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("threefry")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.threefry_draw.argtypes = [ctypes.c_uint, ctypes.c_uint,
                                  ctypes.c_longlong, ctypes.c_longlong, i,
                                  f, f, f, i, i, i, p, i, p]
    lib.threefry_draw.restype = ctypes.c_int
    return lib


def _check(out: torch.Tensor, dist: int, real: bool) -> None:
    want = (torch.int32,) if dist == DISTS["bits"] else (torch.float32,
                                                           torch.bfloat16)
    if out.dtype not in want:
        raise TypeError(f"out must be one of {want}, got {out.dtype}")
    _build.check_tensor("out", out, out.dtype, tuple(out.shape), out.device,
                        real)


def _launch(out, k0: int, k1: int, offset: int, dist: int, lo: float,
            hi: float, scale: float, divide: bool, bf16_math: bool):
    """The op's CUDA implementation: check, launch into ``out``."""
    _check(out, dist, True)
    span = (prng.round_bf16 if bf16_math else prng.round_f32)(hi - lo)
    lib = _lib()
    status = lib.threefry_draw(
        k0, k1, offset, out.numel(), dist, lo, span, scale, int(divide),
        int(bf16_math), int(out.dtype == torch.bfloat16), out.data_ptr(),
        out.device.index, torch.cuda.current_stream(out.device).cuda_stream)
    _build.check(lib, status, "threefry_draw")
    threefry_cuda.launches += 1


def _plain_op(out, k0: int, k1: int, offset: int, dist: int, lo: float,
              hi: float, scale: float, divide: bool, bf16_math: bool):
    """The op's CPU implementation: the plain version into ``out``, chunk
    by chunk on one intra-op thread (a chunk's log1p and sqrt would
    otherwise wake every thread, which then spin between the chunk's ~170
    small operations: 10x the CPU time for no gain in wall time)."""
    _check(out, dist, False)
    key = torch.tensor([k0, k1], dtype=torch.int64)
    name = next(k for k, v in DISTS.items() if v == dist)
    flat = out.view(-1)
    with intra_op_threads(1):
        for start in range(0, out.numel(), CHUNK):
            part = flat[start:start + CHUNK]
            got = threefry_plain(key, part.numel(), name, lo=lo, hi=hi,
                                 scale=scale, divide=divide,
                                 bf16_math=bf16_math, offset=offset + start,
                                 device=out.device)
            part.copy_(got)


def _fake(out, k0: int, k1: int, offset: int, dist: int, lo: float,
          hi: float, scale: float, divide: bool, bf16_math: bool):
    _check(out, dist, False)


def flops(*shapes, out_shape=None) -> int:
    """No products: the work is integer hashing."""
    return 0


OP = _build.define_op(
    "threefry",
    "(Tensor(a!) out, int k0, int k1, int offset, int dist, float lo, "
    "float hi, float scale, bool divide, bool bf16_math) -> ()",
    cuda=_launch, cpu=_plain_op, fake=_fake, flops=flops)


def _op_args(key: torch.Tensor, dist: str, lo: float, hi: float,
             scale: float, divide: bool, bf16_math: bool, offset: int):
    if dist not in DISTS:
        raise ValueError(f"unknown distribution {dist!r}")
    k0, k1 = prng.words(key)
    lo, hi, scale = _params(dist, lo, hi, scale, divide, bf16_math)
    return (k0, k1, int(offset), DISTS[dist], lo, hi, scale, bool(divide),
            bool(bf16_math))


def threefry_cuda(out: torch.Tensor, key: torch.Tensor, dist: str = "normal",
                  *, lo: float = 0.0, hi: float = 1.0, scale: float = 1.0,
                  divide: bool = False, bf16_math: bool = False,
                  offset: int = 0) -> torch.Tensor:
    """Launch the CUDA kernel into ``out`` (a contiguous CUDA tensor:
    int32 for ``"bits"``, float32 or bf16 otherwise).  Returns ``out``."""
    _build.check_plain("threefry_cuda", out)
    if out.device.type != "cuda":
        raise ValueError(f"out must be a CUDA tensor, got {out.device}")
    OP(out, *_op_args(key, dist, lo, hi, scale, divide, bf16_math, offset))
    return out


#: Launches of the CUDA kernel since the last reset (``launches = 0``).
threefry_cuda.launches = 0


def draw(out: torch.Tensor, key: torch.Tensor, dist: str = "normal", *,
         lo: float = 0.0, hi: float = 1.0, scale: float = 1.0,
         divide: bool = False, bf16_math: bool = False,
         offset: int = 0) -> torch.Tensor:
    """Fill ``out`` with elements ``[offset, offset + out.numel())`` of the
    stream of ``key``: the kernel on the card, the plain version on the
    CPU.  Returns ``out``."""
    if out.device.type == "cuda":
        return threefry_cuda(out, key, dist, lo=lo, hi=hi, scale=scale,
                             divide=divide, bf16_math=bf16_math,
                             offset=offset)
    _plain_op(out, *_op_args(key, dist, lo, hi, scale, divide, bf16_math,
                             offset))
    return out


def randint(key: torch.Tensor, shape, minval: int, maxval: int, *,
            device=None) -> torch.Tensor:
    """``prng.randint(key, shape, minval, maxval)`` drawn on ``device``
    (the CPU if None): its two 32-bit streams by :func:`draw` in
    ``"bits"`` mode (two launches of the kernel on the card, the plain
    version on the CPU), then :func:`prng.randint_from_bits` in int64 on
    the device.  Returns int64 on ``device``."""
    device = torch.device("cpu") if device is None else torch.device(device)
    high, low = (draw(torch.empty(shape, dtype=torch.int32, device=device),
                      k, "bits").long().bitwise_and_(prng.MASK)
                 for k in prng.split(key))
    return prng.randint_from_bits(high, low, minval, maxval)


def int_ops(numel: int, dist: str) -> int:
    """32-bit integer operations of a draw an element, counted from the
    source: the counter's 64-bit add (2), threefry's key additions (2 + 5
    x 2) and 20 rounds of add, rotate and xor (60), the output's xor (1),
    and for a uniform or normal the mantissa's shift and or (2)."""
    return numel * (75 + (0 if dist == "bits" else 2))


def float_ops(numel: int, dist: str) -> int:
    """Float operations a uniform (FMA, max, scale) or normal (also
    erf_inv's square, log1p as ~20, the branch's subtraction or square
    root, 8 FMAs, the product and sqrt(2)) takes an element."""
    return numel * {"bits": 0, "uniform": 3, "normal": 36}[dist]

