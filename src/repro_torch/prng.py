"""``jax.random``'s threefry streams in plain PyTorch.

The JAX package draws its seeded weights, batches and prompts from
``jax.random`` with the default ``threefry2x32`` implementation in its
partitionable mode (``jax_threefry_partitionable``, on by default).  This
module computes the same streams, so that a seeded run of the port starts
from the reference's numbers.  Keys are int64 tensors of shape ``[2]`` on
the CPU holding uint32 words; draws are int64 tensors holding uint32 (or
narrower) values, masked after every add and shift, and come out on any
device.  Each draw takes a counter ``offset``: the elements ``[offset,
offset + numel)`` of the row-major draw of a larger shape, so a leaf can
be drawn in parts that equal the whole draw.

Where XLA contracts a product and a sum into one fused multiply-add, the
plain version computes the product and the sum in float64 and rounds once
to float32 (:func:`_fma`): a product of two float32 values is exact in
float64, so only a sum that needs more than 53 bits rounds twice.
:mod:`repro_torch.kernels.threefry` draws the same streams on the card in
one launch a leaf.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import torch

MASK = 0xFFFFFFFF
#: Threefry-2x32's rotations, alternating between the two groups of four
#: rounds (``jax._src.prng._threefry2x32_lowering``).
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

Shape = Union[int, Sequence[int]]


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (int(shape),) if isinstance(shape, int) else tuple(
        int(d) for d in shape)


def threefry2x32(k0, k1, x0: torch.Tensor, x1: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 (20 rounds) of the counter pairs ``(x0, x1)`` under
    the key ``(k0, k1)`` (ints, or int64 tensors broadcasting with the
    counters).  Returns the two output words as int64 tensors."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = x0.add_(x1).bitwise_and_(MASK)
            x1 = ((x1 << r).bitwise_or_(x1 >> (32 - r))).bitwise_and_(MASK)
            x1 = x1.bitwise_xor_(x0)
        x0 = x0.add_(ks[(i + 1) % 3]).bitwise_and_(MASK)
        x1 = x1.add_(ks[(i + 2) % 3] + i + 1).bitwise_and_(MASK)
    return x0, x1


def words(key: torch.Tensor) -> Tuple[int, int]:
    """A key's two uint32 words as Python ints."""
    k0, k1 = (int(w) for w in key.tolist())
    return k0, k1


def key(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` as the JAX package calls it, with
    ``jax_enable_x64`` off: the seed is an int32 (a Python int wraps mod
    2**32), so ``prng.threefry_seed``'s ``[seed >> 32, seed &
    0xFFFFFFFF]`` is ``[0, seed mod 2**32]``."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64)


def _counters(n: int, offset: int, device) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """The flat iota ``[offset, offset + n)`` split into hi and lo words
    (``prng.iota_2x32_shape``)."""
    flat = torch.arange(offset, offset + n, dtype=torch.int64, device=device)
    return flat >> 32, flat & MASK


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` in partitionable mode
    (``prng._threefry_split_foldlike``): key ``i`` is the two output words
    of counter ``(0, i)``.  Returns ``[num, 2]``."""
    hi, lo = _counters(num, 0, "cpu")
    o0, o1 = threefry2x32(*words(key), hi, lo)
    return torch.stack([o0, o1], dim=1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: the hash of the counter ``(0,
    data mod 2**32)`` (``prng.threefry_fold_in``)."""
    o0, o1 = threefry2x32(*words(key), torch.zeros(1, dtype=torch.int64),
                          torch.tensor([int(data) & MASK]))
    return torch.cat([o0, o1])


def bits(key: torch.Tensor, shape: Shape, width: int = 32, *,
         offset: int = 0, device=None) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32 / uint16)`` in partitionable
    mode (``prng._threefry_random_bits_partitionable``): element ``i`` of
    the row-major draw hashes counter ``i`` (hi and lo words) and is
    ``out0 ^ out1``; 16- and 8-bit bits are its low bits.  ``offset`` shifts the
    counters.  Returns int64."""
    if width not in (8, 16, 32):
        raise ValueError(f"width must be 8, 16 or 32, got {width}")
    shape = _shape(shape)
    hi, lo = _counters(math.prod(shape), offset, device)
    o0, o1 = threefry2x32(*words(key), hi, lo)
    out = o0.bitwise_xor_(o1)
    if width < 32:
        out = out.bitwise_and_((1 << width) - 1)
    return out.reshape(shape)


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as XLA contracts it (``b`` and
    ``c`` float32 tensors or Python floats holding float32 values)."""
    def wide(x):
        return x.double() if torch.is_tensor(x) else x
    return (a.double() * wide(b) + wide(c)).float()


def round_f32(x: float) -> float:
    """``x`` rounded to float32, as a Python float."""
    return float(torch.tensor(x, dtype=torch.float32))


def round_bf16(x: float) -> float:
    """``x`` rounded to bf16, as a Python float."""
    return float(torch.tensor(x, dtype=torch.bfloat16))


def _unit(key: torch.Tensor, shape: Shape, dtype: torch.dtype, offset: int,
          device) -> torch.Tensor:
    """Floats in [0, 1): the top bits of a draw as the mantissa under the
    exponent of 1.0, minus 1 (``random._uniform``).  fp32 takes 23 of 32
    bits; bf16, whose 7 mantissa bits are fewer than 8, takes 7 of 8."""
    if dtype == torch.float32:
        raw = bits(key, shape, 32, offset=offset, device=device)
        f = ((raw >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    elif dtype == torch.bfloat16:
        raw = bits(key, shape, 8, offset=offset, device=device)
        f = ((raw >> 1) | 0x3F80).to(torch.int16).view(torch.bfloat16)
    else:
        raise TypeError(f"dtype must be float32 or bfloat16, got {dtype}")
    return f - 1.0


def uniform(key: torch.Tensor, shape: Shape, dtype=torch.float32,
            minval: float = 0.0, maxval: float = 1.0, *, offset: int = 0,
            device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, dtype, minval, maxval)``:
    ``max(lo, f * (hi - lo) + lo)`` with ``f`` in [0, 1) from the top
    mantissa bits of 32-bit (fp32) or 8-bit (bf16) bits, ``lo``, ``hi``
    and ``hi - lo`` in ``dtype``, the product and sum one FMA."""
    f = _unit(key, shape, dtype, offset, device)
    rnd = round_f32 if dtype == torch.float32 else round_bf16
    lo, hi = rnd(minval), rnd(maxval)
    span = rnd(hi - lo)
    return torch.clamp_min(_fma(f.float(), span, lo).to(dtype), lo)


# XLA's single-precision erf_inv (chlo.erf_inv, Giles' polynomial in w)
ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                -4.39150654e-06, 0.00021858087, -0.00125372503,
                -0.00417768164, 0.246640727, 1.50140941)
ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322,
                -0.00367342844, 0.00573950773, -0.0076224613,
                0.00943887047, 1.00167406, 2.83297682)


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv``: ``w = -log1p(-x * x)``; below 5 the
    polynomial in ``w - 2.5``, else in ``sqrt(w) - 3``, by Horner's rule
    with each step one FMA; times ``x``; ``x * inf`` at ``|x| == 1``."""
    w = -torch.log1p(-(x * x))
    small = w < 5.0
    t = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0)
    lo = torch.tensor(ERFINV_SMALL, dtype=torch.float32, device=x.device)
    hi = torch.tensor(ERFINV_LARGE, dtype=torch.float32, device=x.device)
    p = torch.where(small, lo[0], hi[0])
    for i in range(1, len(ERFINV_SMALL)):
        p = _fma(p, t, torch.where(small, lo[i], hi[i]))
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


#: float32(sqrt(2)), the factor of ``random._normal_real``.
SQRT2 = round_f32(math.sqrt(2.0))


def normal(key: torch.Tensor, shape: Shape, dtype=torch.float32, *,
           offset: int = 0, device=None) -> torch.Tensor:
    """``jax.random.normal(key, shape, dtype)``: ``sqrt(2) *
    erf_inv(u)`` with ``u`` uniform in ``[nextafter(-1, 0), 1)`` of
    ``dtype``.  A bf16 draw takes bf16 uniforms, whose ``erf_inv`` runs in
    float32 (XLA upcasts it) and is rounded to bf16, then times
    ``bf16(sqrt(2))`` in bf16."""
    lo = -1.0 + (2.0 ** -24 if dtype == torch.float32 else 2.0 ** -8)
    u = uniform(key, shape, dtype, lo, 1.0, offset=offset, device=device)
    if dtype == torch.float32:
        return SQRT2 * erfinv(u)
    return erfinv(u.float()).to(dtype) * round_bf16(math.sqrt(2.0))


def randint(key: torch.Tensor, shape: Shape, minval: int, maxval: int, *,
            offset: int = 0, device=None) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32): two
    32-bit draws from ``split(key)``, ``span = maxval - minval``,
    ``m = (2**16 % span)**2 % span`` (the square wraps in uint32) and
    ``minval + ((hi % span) * m + lo % span) % span``, every sum and
    product wrapping in uint32.  Returns int64."""
    k1, k2 = split(key)
    span = max(int(maxval) - int(minval), 1)
    mult = (((1 << 16) % span) ** 2 & MASK) % span
    high = bits(k1, shape, offset=offset, device=device) % span
    low = bits(k2, shape, offset=offset, device=device) % span
    r = (high.mul_(mult).bitwise_and_(MASK).add_(low).bitwise_and_(MASK)
         % span)
    return r.add_(int(minval))
