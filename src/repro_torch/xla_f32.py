"""XLA's CPU float32 ``linspace``, ``log`` and ``expm1``, bit for bit.

The JAX package computes two fixed (non-random) leaves with them: Mamba-2's
``a_log = log(linspace(1, 16, heads))`` (``repro.models.ssm``) and the
RG-LRU's ``a_param = log(expm1(-log(linspace(0.9, 0.999, width))))``
(``repro.models.rglru``).  torch's ``linspace``, ``log`` and ``expm1``
differ from XLA's by ulps, which ``a_param`` amplifies to ~70, so the port
computes them as XLA's CPU code does (jax 0.9 on x86-64, read from the
LLVM IR that ``XLA_FLAGS=--xla_dump_to`` writes and matched against jax):

- ``jnp.linspace``: ``iota / div`` becomes ``iota * f32(1 / div)``, and
  ``stop * step`` becomes ``iota * (stop * r)``; the last product and its
  sum are one FMA.  Where LLVM unrolls the loop whole (``n`` up to
  :data:`UNROLLED`), ``1 - iota * r`` is a constant computed in two
  roundings; otherwise the vector body's 32-element steps compute it as
  an FMA and only the tail as constants.
- ``log``: Cephes' ``logf`` polynomial (XLA's vectorised ``log_f32``),
  ``exp`` Cephes' ``expf`` and ``tanh`` XLA's rational approximation,
  each product feeding one sum contracted to an FMA.
- ``expm1(x)``: ``exp(x) - 1`` where ``|x| > 0.5``, else ``tanh(x / 2) *
  (exp(x) + 1)``; ``x`` where ``x / 2`` is 0.

An FMA is :func:`repro_torch.prng._fma` (the float64 product and sum
rounded once more to float32).  Every function takes and returns float32
CPU tensors.
"""

from __future__ import annotations

import torch

from .prng import _fma, round_f32

#: jnp.linspace lengths whose loop LLVM unrolls whole (found by matching
#: jax 0.9's output for every n from 3 to 700).
UNROLLED = 352
#: The vector body's step, in elements (four vectors of eight floats).
BODY_STEP = 32

_F32 = torch.float32
_LOG_P = tuple(map(round_f32, (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1)))
_LOG_Q1, _LOG_Q2 = round_f32(-2.12194440e-4), round_f32(0.693359375)
_SQRTHF = round_f32(0.707106781186547524)
_EXP_P = tuple(map(round_f32, (1.9875691500e-4, 1.3981999507e-3,
                               8.3334519073e-3, 4.1665795894e-2,
                               1.6666665459e-1, 0.5)))
_LOG2EF = round_f32(1.44269504088896341)
_TANH_ALPHA = tuple(map(round_f32, (
    4.89352455891786e-03, 6.37261928875436e-04, 1.48572235717979e-05,
    5.12229709037114e-08, -8.60467152213735e-11, 2.00018790482477e-13,
    -2.76076847742355e-16)))
_TANH_BETA = tuple(map(round_f32, (4.89352518554385e-03,
                                   2.26843463243900e-03,
                                   1.18534705686654e-04,
                                   1.19825839466702e-06)))
_TANH_CLAMP = round_f32(7.99881172180175781)


def linspace(start: float, stop: float, n: int) -> torch.Tensor:
    """``jnp.linspace(start, stop, n)`` in float32 (endpoint included)."""
    if n < 2:
        return torch.full((n,), round_f32(start), dtype=_F32)
    start, stop, div = round_f32(start), round_f32(stop), n - 1
    r = float(torch.tensor(1.0, dtype=_F32) / div)
    i = torch.arange(div, dtype=_F32)
    one_minus = 1.0 - i * r
    if n > UNROLLED:
        body = BODY_STEP * (div // BODY_STEP)
        one_minus[:body] = _fma(-i[:body], r, 1.0)
    out = _fma(i, round_f32(stop * r), start * one_minus)
    return torch.cat([out, torch.tensor([stop], dtype=_F32)])


def log(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU float32 ``log``, for finite ``x > 0``."""
    x = torch.clamp_min(x, 2.0 ** -126)
    bits = x.view(torch.int32)
    e = ((bits >> 23) - 127).to(_F32) + 1.0
    m = ((bits & ~0x7F800000) | 0x3F000000).view(_F32)   # in [0.5, 1)
    low = m < _SQRTHF
    e = e - low.to(_F32)
    x = (m - 1.0) + torch.where(low, m, 0.0)
    x2 = x * x
    x3 = x2 * x
    p = _LOG_P
    y = _fma(_fma(x, p[0], p[1]), x, p[2])
    y1 = _fma(_fma(x, p[3], p[4]), x, p[5])
    y2 = _fma(_fma(x, p[6], p[7]), x, p[8])
    y = _fma(_fma(y, x3, y1), x3, y2)
    y = _fma(y, x3, _LOG_Q1 * e)
    return _fma(e, _LOG_Q2, _fma(x2, -0.5, x) + y)


def _exp(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU float32 ``exp`` (Cephes' ``expf``)."""
    x = torch.clamp(x, round_f32(-87.8), round_f32(88.8))
    n = torch.clamp(torch.floor(_fma(x, _LOG2EF, 0.5)), -127.0, 127.0)
    x = _fma(n, -0.693359375, x)
    x = _fma(n, round_f32(2.12194440e-4), x)
    y = _fma(x, _EXP_P[0], _EXP_P[1])
    for c in _EXP_P[2:]:
        y = _fma(y, x, c)
    y = _fma(y, x * x, x) + 1.0
    two_n = ((n.to(torch.int32) << 23) + 0x3F800000).view(_F32)
    return y * two_n


def _tanh(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU float32 ``tanh``: ``x`` below 0.0004, a rational
    function of the input clamped to +-7.9988, +-1 from 20."""
    xc = torch.clamp(x, -_TANH_CLAMP, _TANH_CLAMP)
    s = xc * xc
    num = torch.full_like(s, _TANH_ALPHA[-1])
    for a in _TANH_ALPHA[-2::-1]:
        num = _fma(s, num, a)
    den = torch.full_like(s, _TANH_BETA[-1])
    for b in _TANH_BETA[-2::-1]:
        den = _fma(s, den, b)
    out = torch.where(x.abs() < 0.0004, x, xc * num / den)
    return torch.where(x.abs() >= 20.0, torch.copysign(
        torch.ones_like(x), x), out)


def expm1(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU float32 ``expm1``."""
    e = _exp(x)
    half = x * 0.5
    out = torch.where(x.abs() > 0.5, e - 1.0, _tanh(half) * (e + 1.0))
    return torch.where(half == 0.0, x, out)
