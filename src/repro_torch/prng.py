"""``jax.random``'s threefry streams in plain PyTorch.

The JAX package draws its seeded weights, batches and prompts from
``jax.random`` with the default ``threefry2x32`` implementation in its
partitionable mode (``jax_threefry_partitionable``, on by default).  This
module computes the same streams, so that a seeded run of the port starts
from the reference's numbers.  Keys are int64 tensors of shape ``[2]`` on
the CPU holding uint32 words; ``key``, ``split`` and ``fold_in`` hash them
in Python integers (:func:`hash_words`), a few microseconds a key.  The
element draws hash int32 tensors holding the words' bits, whose adds wrap
as uint32 adds do (:func:`threefry2x32`), and come out on any device;
``bits`` returns them as int64 tensors holding uint32 (or narrower)
values.  Each draw takes a counter ``offset``: the elements ``[offset,
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


def _i32(word: int) -> int:
    """A uint32 word as the int32 with its bits."""
    word &= MASK
    return word - (1 << 32) if word >> 31 else word


#: Each group of four rounds: its rotations as (r, 32 - r), and the key
#: words and count injected after it.
_SCHEDULE = tuple((tuple((r, 32 - r) for r in ROTATIONS[i % 2]),
                   (i + 1) % 3, (i + 2) % 3, i + 1) for i in range(5))


def hash_words(k0: int, k1: int, x0: int, x1: int) -> Tuple[int, int]:
    """Threefry-2x32 (20 rounds) of one counter pair ``(x0, x1)`` under
    the key ``(k0, k1)``, all uint32 words as Python ints: the key tree's
    hash."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0, x1 = (x0 + k0) & MASK, (x1 + k1) & MASK
    for rotations, a, b, count in _SCHEDULE:
        for r, rr in rotations:
            x0 = (x0 + x1) & MASK
            x1 = ((x1 << r) & MASK | x1 >> rr) ^ x0
        x0 = (x0 + ks[a]) & MASK
        x1 = (x1 + ks[b] + count) & MASK
    return x0, x1


def threefry2x32(k0: int, k1: int, x0, x1: torch.Tensor) -> torch.Tensor:
    """Threefry-2x32 (20 rounds) of the counter pairs ``(x0, x1)`` under
    the key ``(k0, k1)`` (uint32 ints), on the words' bits as int32: a
    uint32 add is an int32 add that wraps, and a rotation masks its
    arithmetic right shift.  ``x0`` is a uint32 int or an int32 tensor,
    ``x1`` an int32 tensor broadcasting with it.  Returns ``out0 ^ out1``
    (int32), the one output every draw uses."""
    ks = (_i32(k0), _i32(k1), _i32(k0 ^ k1 ^ _PARITY))
    x0 = x0 + ks[0] if torch.is_tensor(x0) else _i32(x0 + k0)
    x1 = x1 + ks[1]
    for i, (rotations, a, b, count) in enumerate(_SCHEDULE):
        for j, (r, rr) in enumerate(rotations):
            # the first round's x0 may be a number
            x0 = x1 + x0 if i == j == 0 else x0.add_(x1)
            hi = x1 << r
            x1 = x1.bitwise_right_shift_(rr).bitwise_and_((1 << r) - 1) \
                .bitwise_or_(hi).bitwise_xor_(x0)
        x0 = x0.add_(ks[a])
        x1 = x1.add_(_i32(ks[b] + count))
    return x0.bitwise_xor_(x1)


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


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` in partitionable mode
    (``prng._threefry_split_foldlike``): key ``i`` is the two output words
    of counter ``(0, i)``.  Returns ``[num, 2]``."""
    k0, k1 = words(key)
    return torch.tensor([hash_words(k0, k1, 0, i) for i in range(num)],
                        dtype=torch.int64)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: the hash of the counter ``(0,
    data mod 2**32)`` (``prng.threefry_fold_in``)."""
    return torch.tensor(hash_words(*words(key), 0, int(data) & MASK),
                        dtype=torch.int64)


def bits32(key: torch.Tensor, numel: int, *, offset: int = 0,
           device=None) -> torch.Tensor:
    """Elements ``[offset, offset + numel)`` of ``jax.random.bits(key,
    ..., uint32)`` in partitionable mode
    (``prng._threefry_random_bits_partitionable``), flat, as int32 with
    the words' bits: element ``i`` hashes counter ``i``, split into its hi
    and lo words (``prng.iota_2x32_shape``), and is ``out0 ^ out1``."""
    flat = torch.arange(offset, offset + numel, dtype=torch.int64,
                        device=device)
    hi = offset >> 32           # one hi word for the whole range, mostly
    x0 = hi if (offset + numel - 1) >> 32 == hi else \
        (flat >> 32).to(torch.int32)
    x1 = flat.to(torch.int32)   # the lo words' bits
    return threefry2x32(*words(key), x0, x1)


def bits(key: torch.Tensor, shape: Shape, width: int = 32, *,
         offset: int = 0, device=None) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32 / uint16 / uint8)`` in
    partitionable mode (:func:`bits32`); 16- and 8-bit bits are its low
    bits.  ``offset`` shifts the counters.  Returns int64."""
    if width not in (8, 16, 32):
        raise ValueError(f"width must be 8, 16 or 32, got {width}")
    shape = _shape(shape)
    out = bits32(key, math.prod(shape), offset=offset,
                 device=device).long()
    return out.bitwise_and_((1 << width) - 1).reshape(shape)


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


def _unit(key: torch.Tensor, numel: int, dtype: torch.dtype, offset: int,
          device) -> torch.Tensor:
    """``numel`` floats in [0, 1): the top bits of a draw as the mantissa
    under the exponent of 1.0, minus 1 (``random._uniform``).  fp32 takes
    23 of 32 bits; bf16, whose 7 mantissa bits are fewer than 8, takes 7
    of 8."""
    raw = bits32(key, numel, offset=offset, device=device)
    if dtype == torch.float32:
        f = raw.bitwise_right_shift_(9).bitwise_and_(0x7FFFFF) \
            .bitwise_or_(0x3F800000).view(torch.float32)
    elif dtype == torch.bfloat16:
        f = raw.bitwise_and_(0xFF).bitwise_right_shift_(1) \
            .bitwise_or_(0x3F80).to(torch.int16).view(torch.bfloat16)
    else:
        raise TypeError(f"dtype must be float32 or bfloat16, got {dtype}")
    return f.sub_(1.0)


def uniform(key: torch.Tensor, shape: Shape, dtype=torch.float32,
            minval: float = 0.0, maxval: float = 1.0, *, offset: int = 0,
            device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, dtype, minval, maxval)``:
    ``max(lo, f * (hi - lo) + lo)`` with ``f`` in [0, 1) from the top
    mantissa bits of 32-bit (fp32) or 8-bit (bf16) bits, ``lo``, ``hi``
    and ``hi - lo`` in ``dtype``, the product and sum one FMA."""
    shape = _shape(shape)
    f = _unit(key, math.prod(shape), dtype, offset, device)
    rnd = round_f32 if dtype == torch.float32 else round_bf16
    lo, hi = rnd(minval), rnd(maxval)
    span = rnd(hi - lo)
    return torch.clamp_min(_fma(f.float(), span, lo).to(dtype),
                           lo).reshape(shape)


# XLA's single-precision erf_inv (chlo.erf_inv, Giles' polynomial in w)
ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                -4.39150654e-06, 0.00021858087, -0.00125372503,
                -0.00417768164, 0.246640727, 1.50140941)
ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322,
                -0.00367342844, 0.00573950773, -0.0076224613,
                0.00943887047, 1.00167406, 2.83297682)
_ERFINV_F32 = {"small": tuple(map(round_f32, ERFINV_SMALL)),
               "large": tuple(map(round_f32, ERFINV_LARGE))}


def _horner(t: torch.Tensor, coefficients) -> torch.Tensor:
    """float32 ``c0 t^8 + ... + c8`` (float32 values) by Horner's rule,
    each step one FMA: the product of the float32 step and ``t`` (float64,
    holding float32 values) is exact in float64, the sum rounds there and
    then to float32."""
    p = torch.mul(t, coefficients[0]).add_(coefficients[1]).float()
    for c in coefficients[2:]:
        p = torch.mul(p, t).add_(c).float()
    return p


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv``: ``w = -log1p(-x * x)``; below 5 the
    polynomial in ``w - 2.5``, else in ``sqrt(w) - 3``, by Horner's rule
    with each step one FMA; times ``x``; ``x * inf`` at ``|x| == 1``.
    The second branch, ``|x|`` above ~0.9966, runs on its elements
    alone."""
    w = torch.log1p((x * x).neg_()).neg_()
    large = (w < 5.0).logical_not_().nonzero(as_tuple=True)
    out = _horner((w - 2.5).double(), _ERFINV_F32["small"]).mul_(x)
    if large[0].numel():
        wl, xl = w[large], x[large]
        p = _horner((torch.sqrt(wl) - 3.0).double(),
                    _ERFINV_F32["large"])
        out[large] = torch.where(xl.abs() == 1.0, xl * math.inf, p * xl)
    return out


#: float32(sqrt(2)), the factor of ``random._normal_real``.
SQRT2 = round_f32(math.sqrt(2.0))


def normal(key: torch.Tensor, shape: Shape, dtype=torch.float32, *,
           offset: int = 0, device=None) -> torch.Tensor:
    """``jax.random.normal(key, shape, dtype)``: ``sqrt(2) *
    erf_inv(u)`` with ``u`` uniform in ``[nextafter(-1, 0), 1)`` of
    ``dtype``.  A bf16 draw takes bf16 uniforms, whose ``erf_inv`` runs in
    float32 (XLA upcasts it) and is rounded to bf16, then times
    ``bf16(sqrt(2))`` in bf16."""
    shape = _shape(shape)
    if dtype == torch.float32:
        # jax's uniform in [lo, 1) with lo = -1 + 2**-24, whose span 2 -
        # 2**-24 rounds to 2: f * 2 is exact and the exact f * 2 + lo
        # needs 26 bits, so one float32 add rounds as the FMA does; and
        # f * 2 + lo >= lo, so the max with lo changes nothing.
        u = _unit(key, math.prod(shape), dtype, offset, device).mul_(
            2.0).add_(-1.0 + 2.0 ** -24)
        return erfinv(u).mul_(SQRT2).reshape(shape)
    u = uniform(key, shape, dtype, -1.0 + 2.0 ** -8, 1.0, offset=offset,
                device=device)
    return erfinv(u.float()).to(dtype) * round_bf16(math.sqrt(2.0))


def randint_from_bits(high: torch.Tensor, low: torch.Tensor, minval: int,
                      maxval: int) -> torch.Tensor:
    """``jax.random.randint``'s arithmetic on its two 32-bit draws (int64
    tensors holding uint32 values, on any device): ``span = maxval -
    minval``, ``m = (2**16 % span)**2 % span`` (the square wraps in
    uint32) and ``minval + ((high % span) * m + low % span) % span``,
    every sum and product wrapping in uint32.  Returns int64."""
    span = max(int(maxval) - int(minval), 1)
    mult = (((1 << 16) % span) ** 2 & MASK) % span
    r = (high.remainder_(span).mul_(mult).bitwise_and_(MASK)
         .add_(low.remainder_(span)).bitwise_and_(MASK).remainder_(span))
    return r.add_(int(minval))


def randint(key: torch.Tensor, shape: Shape, minval: int, maxval: int, *,
            offset: int = 0, device=None) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32): two
    32-bit draws from ``split(key)`` through :func:`randint_from_bits`.
    Returns int64."""
    k1, k2 = split(key)
    return randint_from_bits(bits(k1, shape, offset=offset, device=device),
                             bits(k2, shape, offset=offset, device=device),
                             minval, maxval)
