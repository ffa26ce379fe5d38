"""The port's ops against the JAX package's, on the CPU.

The same numpy inputs (drawn from ``default_rng``) go through the port's
ops (which take the kernels' plain versions for CPU tensors) and through
the JAX reference oracle, the XLA formulation and the Pallas kernel in
interpret mode, with the cases and tolerances of ``tests/test_kernels.py``.
The CUDA kernels themselves are held to the plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops, ref as jref
from repro.kernels.decode_attention import decode_attention_pallas
from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.rglru_scan import rglru_pallas
from repro.kernels.ssd_scan import ssd_pallas
from repro.models.layers import causal_mask, window_mask
from repro_torch.kernels import ops, ref
from repro_torch.kernels.decode_attention import (
    HEAD_DIMS,
    KV_SMEM,
    decode_attention_cuda,
    plan as decode_plan,
)
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels import rglru_scan as rglru_mod
from repro_torch.kernels.rglru_scan import rglru_cuda
from repro_torch.kernels.ssd_scan import (
    MAX_SMEM as SSD_MAX_SMEM,
    smem_bytes as ssd_smem_bytes,
    ssd_cuda,
    state_tiles_per_warp,
)

# The sweeps of tests/test_kernels.py, dtypes by name.
ATTN_SWEEP = [
    # (B, Sq, Sk, H, KV, D, mask_kind, window, dtype)
    (1, 8, 8, 2, 2, 8, "causal", 0, "float32"),
    (2, 16, 16, 4, 2, 16, "causal", 0, "float32"),
    (2, 16, 24, 4, 1, 8, "none", 0, "float32"),
    (1, 24, 24, 8, 4, 32, "window", 7, "float32"),
    (2, 16, 16, 4, 4, 16, "causal", 0, "bfloat16"),
    (1, 32, 16, 2, 2, 64, "causal", 0, "float32"),   # Sq > Sk
]
DECODE_SWEEP = [
    # (B, S, H, KV, D, dtype)
    (1, 8, 2, 2, 8, "float32"),
    (2, 32, 8, 4, 16, "float32"),
    (3, 17, 4, 1, 32, "float32"),
    (2, 16, 4, 4, 16, "bfloat16"),
]
SSD_SWEEP = [
    # (B, S, H, P, G, N, chunk, dtype)
    (1, 16, 2, 4, 1, 8, 8, "float32"),
    (2, 32, 4, 8, 2, 16, 8, "float32"),
    (1, 24, 2, 8, 1, 4, 12, "float32"),
    (2, 32, 4, 8, 1, 16, 16, "bfloat16"),
]
RGLRU_SWEEP = [
    # (B, S, C, dtype)
    (1, 16, 4, "float32"),
    (2, 48, 12, "float32"),
    (2, 1024, 4, "float32"),       # multi-chunk path
    (2, 32, 8, "bfloat16"),
]
# tests/test_kernels.py: TOL / TOL32 times 10 for attention, 2e-2 / 1e-4
# for decode, 3e-2 / 1e-4 for the scans.  bf16 inputs are rounded to bf16
# identically on both sides; the tolerance covers the bf16 rounding of the
# outputs.
ATTN_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
DECODE_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
SCAN_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
JAX_REFS = ["ref", "xla", "pallas"]


def _pair(a: np.ndarray, dtype: str):
    """One numpy array as a (jax, torch) pair of the same dtype and bits."""
    return (jnp.asarray(a).astype(getattr(jnp, dtype)),
            torch.from_numpy(a).to(getattr(torch, dtype)))


def _np32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("impl", JAX_REFS)
@pytest.mark.parametrize("case", ATTN_SWEEP, ids=str)
def test_flash_attention_matches_jax(case, impl):
    B, Sq, Sk, H, KV, D, kind, window, dtype = case
    rng = np.random.default_rng(ATTN_SWEEP.index(case))
    (jq, tq), (jk, tk), (jv, tv) = (
        _pair(rng.standard_normal(s, dtype=np.float32), dtype)
        for s in ((B, Sq, H, D), (B, Sk, KV, D), (B, Sk, KV, D)))
    if impl == "ref":
        mask = {"causal": causal_mask(Sq, Sk, 0),
                "window": window_mask(Sq, Sk, 0, window)}.get(kind)
        want = jref.attention(jq, jk, jv, mask)
    elif impl == "xla":
        want = jops.flash_attention(jq, jk, jv, mask_kind=kind,
                                    window=window, kv_chunk=7)
    else:
        want = flash_attention_pallas(jq, jk, jv, mask_kind=kind,
                                      window=window, block_q=8, block_k=8)
    got = ops.flash_attention(tq, tk, tv, mask_kind=kind, window=window)
    assert got.dtype == tq.dtype and tuple(got.shape) == (B, Sq, H, D)
    tol = ATTN_TOL[dtype]
    np.testing.assert_allclose(_np32(got), _np32(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("impl", JAX_REFS)
@pytest.mark.parametrize("case", DECODE_SWEEP, ids=str)
def test_decode_attention_matches_jax(case, impl):
    B, S, H, KV, D, dtype = case
    rng = np.random.default_rng(100 + DECODE_SWEEP.index(case))
    (jq, tq), (jk, tk), (jv, tv) = (
        _pair(rng.standard_normal(s, dtype=np.float32), dtype)
        for s in ((B, H, D), (B, S, KV, D), (B, S, KV, D)))
    length = rng.integers(1, S + 1, size=B).astype(np.int32)
    jl, tl = jnp.asarray(length), torch.from_numpy(length)
    if impl == "ref":
        want = jref.decode_attention(jq, jk, jv, jl)
    elif impl == "xla":
        want = jops.decode_attention(jq, jk, jv, jl)
    else:
        want = decode_attention_pallas(jq, jk, jv, jl, block_k=8)
    got = ops.decode_attention(tq, tk, tv, tl)
    assert got.dtype == tq.dtype and tuple(got.shape) == (B, H, D)
    tol = DECODE_TOL[dtype]
    np.testing.assert_allclose(_np32(got), _np32(want), rtol=tol, atol=tol)


def test_decode_attention_zero_length_gives_zeros_like_pallas():
    rng = np.random.default_rng(7)
    B, S, H, KV, D = 3, 16, 4, 2, 8
    (jq, tq), (jk, tk), (jv, tv) = (
        _pair(rng.standard_normal(s, dtype=np.float32), "float32")
        for s in ((B, H, D), (B, S, KV, D), (B, S, KV, D)))
    length = np.array([0, 5, 0], np.int32)
    want = np.asarray(decode_attention_pallas(jq, jk, jv, jnp.asarray(length),
                                              block_k=8))
    got = ops.decode_attention(tq, tk, tv, torch.from_numpy(length)).numpy()
    assert np.all(want[[0, 2]] == 0.0) and np.all(got[[0, 2]] == 0.0)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_fully_masked_rows_give_zeros():
    """A window query row with q_offset past every key sees nothing."""
    rng = np.random.default_rng(8)
    q = torch.from_numpy(rng.standard_normal((1, 4, 2, 8), dtype=np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 4, 2, 8), dtype=np.float32))
    out = ops.flash_attention(q, k, k, mask_kind="window", window=2,
                              q_offset=8)
    assert torch.count_nonzero(out) == 0


def _ssd_inputs(rng, B, S, H, P, G, N, dtype, init=False):
    """numpy inputs of tests/test_kernels.py's SSD cases, as (jax, torch)
    pairs: x, dt, A, B, C and (with ``init``) an initial state."""
    f32 = np.float32
    x = rng.standard_normal((B, S, H, P), dtype=f32) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H), dtype=f32)))
    A = -np.exp(rng.standard_normal((H,), dtype=f32))
    Bm = rng.standard_normal((B, S, G, N), dtype=f32) * 0.3
    Cm = rng.standard_normal((B, S, G, N), dtype=f32) * 0.3
    h0 = rng.standard_normal((B, H, P, N), dtype=f32) * 0.2
    return (_pair(x, dtype), _pair(dt, "float32"), _pair(A, "float32"),
            _pair(Bm, dtype), _pair(Cm, dtype),
            _pair(h0, "float32") if init else (None, None))


@pytest.mark.parametrize("init", [False, True], ids=["zero", "init"])
@pytest.mark.parametrize("impl", JAX_REFS)
@pytest.mark.parametrize("case", SSD_SWEEP, ids=str)
def test_ssd_matches_jax(case, impl, init):
    B, S, H, P, G, N, chunk, dtype = case
    rng = np.random.default_rng(200 + SSD_SWEEP.index(case))
    pairs = _ssd_inputs(rng, B, S, H, P, G, N, dtype, init)
    (jx, tx), (jdt, tdt), (ja, ta), (jb, tb), (jc, tc), (jh0, th0) = pairs
    if impl == "ref":
        want_y, want_h = jref.ssd_scan(jx, jdt, ja, jb, jc, jh0)
    elif impl == "xla":
        want_y, want_h = jops.ssd(jx, jdt, ja, jb, jc, chunk=chunk,
                                  initial_state=jh0)
    else:
        want_y, want_h = ssd_pallas(jx, jdt, ja, jb, jc, chunk=chunk,
                                    initial_state=jh0)
    y, h = ops.ssd(tx, tdt, ta, tb, tc, chunk=chunk, initial_state=th0)
    assert y.dtype == tx.dtype and h.dtype == torch.float32
    tol = SCAN_TOL[dtype]
    np.testing.assert_allclose(_np32(y), _np32(want_y), rtol=tol, atol=tol)
    np.testing.assert_allclose(_np32(h), _np32(want_h), rtol=tol, atol=tol)


def test_ssd_plain_matches_the_sequential_oracle():
    """The port's chunked form against its own sequential oracle."""
    rng = np.random.default_rng(210)
    pairs = _ssd_inputs(rng, 2, 48, 4, 8, 2, 16, "float32", init=True)
    tx, tdt, ta, tb, tc, th0 = (t for _, t in pairs)
    y, h = ops.ssd(tx, tdt, ta, tb, tc, chunk=16, initial_state=th0)
    want_y, want_h = ref.ssd_scan(tx, tdt, ta, tb, tc, th0)
    torch.testing.assert_close(y, want_y, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(h, want_h, rtol=1e-4, atol=1e-4)


def test_ssd_decode_steps_match_the_scan():
    """Decoding token by token equals the full-sequence scan, and the port's
    step equals the JAX package's."""
    rng = np.random.default_rng(211)
    B, S, H, P, G, N = 2, 8, 4, 4, 2, 8
    pairs = _ssd_inputs(rng, B, S, H, P, G, N, "float32", init=True)
    (jx, tx), (jdt, tdt), (ja, ta), (jb, tb), (jc, tc), (jh, th) = pairs
    want_y, want_h = ops.ssd(tx, tdt, ta, tb, tc, chunk=4, initial_state=th)
    ys = []
    for t in range(S):
        y_t, th = ops.ssd_decode_step(tx[:, t], tdt[:, t], ta, tb[:, t],
                                      tc[:, t], th)
        jy_t, jh = jops.ssd_decode_step(jx[:, t], jdt[:, t], ja, jb[:, t],
                                        jc[:, t], jh)
        np.testing.assert_allclose(_np32(y_t), _np32(jy_t), rtol=1e-4,
                                   atol=1e-4)
        ys.append(y_t)
    torch.testing.assert_close(torch.stack(ys, 1), want_y, rtol=1e-4,
                               atol=1e-4)
    torch.testing.assert_close(th, want_h, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np32(th), _np32(jh), rtol=1e-4, atol=1e-4)


def test_ssd_refuses_a_ragged_chunk():
    rng = np.random.default_rng(212)
    pairs = _ssd_inputs(rng, 1, 24, 2, 4, 1, 8, "float32")
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ops.ssd(*(t for _, t in pairs[:5]), chunk=16)


def _rglru_inputs(rng, B, S, C, dtype, init=False):
    """numpy inputs of tests/test_kernels.py's RG-LRU cases, as (jax,
    torch) pairs: x, gate_a, gate_i, log_a and an initial state."""
    f32 = np.float32

    def sigmoid(a):
        return 1.0 / (1.0 + np.exp(-a))

    x = rng.standard_normal((B, S, C), dtype=f32) * 0.5
    ga = sigmoid(rng.standard_normal((B, S, C), dtype=f32))
    gi = sigmoid(rng.standard_normal((B, S, C), dtype=f32))
    la = -np.log1p(np.exp(rng.standard_normal((C,), dtype=f32))) * 0.1
    h0 = rng.standard_normal((B, C), dtype=f32)
    return (_pair(x, dtype), _pair(ga, dtype), _pair(gi, dtype),
            _pair(la, "float32"),
            _pair(h0, "float32") if init else (None, None))


@pytest.mark.parametrize("init", [False, True], ids=["zero", "init"])
@pytest.mark.parametrize("impl", JAX_REFS)
@pytest.mark.parametrize("case", RGLRU_SWEEP, ids=str)
def test_rglru_matches_jax(case, impl, init):
    B, S, C, dtype = case
    rng = np.random.default_rng(300 + RGLRU_SWEEP.index(case))
    pairs = _rglru_inputs(rng, B, S, C, dtype, init)
    (jx, tx), (jga, tga), (jgi, tgi), (jla, tla), (jh0, th0) = pairs
    if impl == "ref":
        want_h, want_T = jref.rglru_scan(jx, jga, jgi, jla, jh0)
    elif impl == "xla":
        want_h, want_T = jops.rglru(jx, jga, jgi, jla, initial_state=jh0)
    else:
        want_h, want_T = rglru_pallas(jx, jga, jgi, jla, initial_state=jh0,
                                      chunk=16)
    h, hT = ops.rglru(tx, tga, tgi, tla, initial_state=th0)
    assert h.dtype == tx.dtype and hT.dtype == torch.float32
    tol = SCAN_TOL[dtype]
    np.testing.assert_allclose(_np32(h), _np32(want_h), rtol=tol, atol=tol)
    np.testing.assert_allclose(_np32(hT), _np32(want_T), rtol=tol, atol=tol)


def test_rglru_decode_steps_match_the_scan():
    """Decoding token by token equals the full-sequence scan, and the port's
    step equals the JAX package's."""
    rng = np.random.default_rng(310)
    B, S, C = 2, 8, 12
    pairs = _rglru_inputs(rng, B, S, C, "float32", init=True)
    (jx, tx), (jga, tga), (jgi, tgi), (jla, tla), (jh, th) = pairs
    want_h, want_T = ops.rglru(tx, tga, tgi, tla, initial_state=th)
    hs = []
    for t in range(S):
        h_t, th = ops.rglru_decode_step(tx[:, t], tga[:, t], tgi[:, t], tla,
                                        th)
        jh_t, jh = jops.rglru_decode_step(jx[:, t], jga[:, t], jgi[:, t],
                                          jla, jh)
        np.testing.assert_allclose(_np32(h_t), _np32(jh_t), rtol=1e-4,
                                   atol=1e-4)
        hs.append(h_t)
    torch.testing.assert_close(torch.stack(hs, 1), want_h, rtol=1e-4,
                               atol=1e-4)
    torch.testing.assert_close(th, want_T, rtol=1e-4, atol=1e-4)


def _rglru_by_chunks(x, ga, gi, la, h0, c=8.0):
    """The CUDA kernel's order of arithmetic, in fp32 on the CPU: S and C
    zero-padded to whole chunks and tiles (a zero row is the identity map
    h -> 1 h + 0); per chunk, each warp's sub-segment composed into a map
    (A, B); warp w's entering state the chunk's, through the maps of warps
    0 .. w - 1 in that order; then its steps rescanned; the last warp's h
    enters the next chunk."""
    T, W = rglru_mod.CHUNK, rglru_mod.WARPS
    sub = T // W
    Bsz, S, C = x.shape
    nc, Cp = -(-S // T), -(-C // rglru_mod.TILE) * rglru_mod.TILE

    def pad(t):
        return torch.nn.functional.pad(t, (0, Cp - C, 0, nc * T - S))

    xp, gap, gip = pad(x), pad(ga), pad(gi)
    lap = torch.nn.functional.pad(la, (0, Cp - C)) * c
    h = (torch.nn.functional.pad(h0, (0, Cp - C)) if h0 is not None
         else torch.zeros((Bsz, Cp)))
    out = torch.zeros((Bsz, nc * T, Cp))
    for chunk in range(nc):
        rows = slice(chunk * T, (chunk + 1) * T)
        log_at = lap * gap[:, rows]
        a = torch.exp(log_at)
        b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_at), min=0.0)) \
            * (gip[:, rows] * xp[:, rows])
        a, b = a.view(Bsz, W, sub, Cp), b.view(Bsz, W, sub, Cp)
        maps_a, maps_b = torch.ones((Bsz, W, Cp)), torch.zeros((Bsz, W, Cp))
        for k in range(sub):
            maps_a = a[:, :, k] * maps_a
            maps_b = a[:, :, k] * maps_b + b[:, :, k]
        for w in range(W):
            hw = h
            for j in range(w):
                hw = maps_a[:, j] * hw + maps_b[:, j]
            for k in range(sub):
                hw = a[:, w, k] * hw + b[:, w, k]
                out[:, chunk * T + w * sub + k] = hw
        h = hw
    return out[:, :S, :C], h[:, :C]


RGLRU_CHUNKED = [
    # (B, S, C, decay, initial_state): ragged S and C; one whole chunk and
    # tile; S 0; decay 10 makes each sub-segment's product of a underflow
    # to 0 while every a stays above 0, decay 100 every a itself.
    (2, 300, 100, 1.0, True),
    (1, 77, 40, 1.0, False),
    (1, 64, 32, 1.0, True),
    (3, 130, 33, 10.0, True),
    (2, 200, 72, 100.0, True),
    (2, 0, 40, 1.0, True),
]


@pytest.mark.parametrize("case", RGLRU_CHUNKED, ids=str)
def test_rglru_chunked_composition_matches_the_sequential_scan(case):
    B, S, C, decay, init = case
    rng = np.random.default_rng(320 + RGLRU_CHUNKED.index(case))
    f32 = np.float32

    def sigmoid(a):
        return 1.0 / (1.0 + np.exp(-a))

    x = torch.from_numpy(rng.standard_normal((B, S, C), dtype=f32) * 0.5)
    ga = torch.from_numpy(sigmoid(rng.standard_normal((B, S, C), dtype=f32)))
    gi = torch.from_numpy(sigmoid(rng.standard_normal((B, S, C), dtype=f32)))
    la = torch.from_numpy(
        -np.log1p(np.exp(rng.standard_normal((C,), dtype=f32))) * decay)
    h0 = torch.from_numpy(rng.standard_normal((B, C), dtype=f32)) \
        if init else None
    got_h, got_T = _rglru_by_chunks(x, ga, gi, la, h0)
    want_h, want_T = ref.rglru_scan(x, ga, gi, la, h0)
    assert torch.isfinite(got_h).all() and torch.isfinite(got_T).all()
    torch.testing.assert_close(got_h, want_h, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got_T, want_T, rtol=1e-5, atol=1e-5)
    if decay > 1.0:
        # The decay really underflows: in the first sub-segment, some
        # channel's product of a is 0 (decay 10: with every a above 0).
        a = torch.exp(8.0 * la * ga[:, :rglru_mod.CHUNK // rglru_mod.WARPS])
        gone = a.prod(dim=1) == 0
        if decay == 10.0:
            gone &= (a > 0).all(dim=1)
        assert bool(gone.any())


def test_rglru_geometry_mirrors_the_kernel_source():
    """``CHUNK``, ``TILE`` and ``WARPS`` (what the test above composes by)
    equal the constants of ``csrc/rglru_scan.cu``."""
    import re

    from repro_torch.kernels import _build

    src = (_build.CSRC / "rglru_scan.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    assert (const("T"), const("TILE"), const("WARPS")) == \
        (rglru_mod.CHUNK, rglru_mod.TILE, rglru_mod.WARPS)
    assert rglru_mod.CHUNK % rglru_mod.WARPS == 0


def test_flash_head_dims_mirror_the_kernel_dispatch():
    """Every (D, Dv) the flash wrapper lets through has a launch in
    ``csrc/flash_attention.cu``'s dispatch, and no other pair has one, so
    a pair the wrapper accepts never reaches the C entry's error return;
    each fits the kernel's two-stage shared memory (BN 64 past 128)."""
    import re

    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import HEAD_DIMS as FLASH_DIMS

    src = (_build.CSRC / "flash_attention.cu").read_text()
    cases = re.findall(r"if \(D == (\d+) && Dv == (\d+)\).*\n\s+return "
                       r"\(int\)launch<(\d+), (\d+)>", src)
    assert all((d, dv) == (d2, dv2) for d, dv, d2, dv2 in cases)
    assert sorted((int(d), int(dv)) for d, dv, _, _ in cases) == \
        sorted(FLASH_DIMS)
    for d, dv in FLASH_DIMS:
        bn = 64 if max(d, dv) > 128 else 128
        assert 128 * d * 2 + 2 * bn * (d + dv) * 2 + 64 + 1024 <= 232448


@pytest.mark.parametrize("dims", HEAD_DIMS, ids=str)
def test_decode_split_plan_covers_the_cache_within_shared_memory(dims):
    D, Dv = dims
    cap = KV_SMEM // (2 * (D + Dv))       # keys whose K and V fit at once
    for S in (1, 7, 63, 200, 1096, 2048, 4096, 32768):
        for G in (1, 5, 8, 10, 16):
            for bkv in (1, 4, 16, 64):
                n_split, smem = decode_plan(S, D, Dv, G, bkv, 132)
                assert 1 <= n_split <= S
                assert n_split * cap >= S
                assert smem <= 227 * 1024


def test_decode_split_plan_fills_the_card_at_the_serve_shapes():
    # yi-6b: B 4 x 4 KV heads, 1096 slots; recurrentgemma-2b: B 4 x 1 KV
    # head, a 2048-slot ring, head dim 256.
    for S, D, G, bkv in ((1096, 128, 8, 16), (2048, 256, 10, 4)):
        n_split, _ = decode_plan(S, D, D, G, bkv, 132)
        assert n_split * bkv >= 132


# (Q, P, N): mamba2-2.7b's serve shape, the ragged and grouped cases of
# tests/test_torch_cuda.py, a chunk of 256, and the widest states taken.
SSD_KERNEL_SHAPES = [(128, 64, 128), (48, 24, 40), (64, 32, 64), (16, 16, 16),
                     (200, 64, 64), (256, 32, 32), (64, 64, 256),
                     (64, 128, 64), (48, 21, 35)]


@pytest.mark.parametrize("shape", SSD_KERNEL_SHAPES, ids=str)
def test_ssd_smem_mirror_equals_the_kernel_layout(shape):
    """``smem_bytes`` (what the wrapper checks) against the layout written
    out region by region, as the note at the head of ``ssd_scan.cu`` gives
    it; every taken shape fits an H100 CTA."""
    Q, P, N = shape
    Qp, Pp, Np = (-(-v // 16) * 16 for v in shape)
    bf16, f32, warps = 2, 4, 8
    x = Qp * (Pp + 8) * bf16
    b_and_c = 2 * Qp * (Np + 8) * bf16
    dt = Qp * f32
    state = Pp * (Np + 8) * bf16
    cum_and_w = 2 * Qp * f32
    partials = warps // 2 * 16 * Pp * f32
    y_out = warps * 16 * (Pp + 8) * bf16
    mbarriers = 2 * 8
    assert ssd_smem_bytes(Q, P, N) == 2 * (x + b_and_c + dt) + state \
        + cum_and_w + partials + y_out + mbarriers
    assert ssd_smem_bytes(Q, P, N) <= SSD_MAX_SMEM


def test_ssd_smem_at_the_serve_shape_and_past_the_limit():
    assert ssd_smem_bytes(128, 64, 128) == 230416
    assert ssd_smem_bytes(256, 64, 256) > SSD_MAX_SMEM


@pytest.mark.parametrize("shape", SSD_KERNEL_SHAPES, ids=str)
def test_ssd_state_tiling_covers_the_state_once(shape):
    """The kernel's warp grid over the state (``Tiling`` in the source):
    every 16 x 8 tile of the padded [P, N] state has exactly one warp, and
    no warp holds more than the 16 tiles its registers take."""
    _, P, N = shape
    mt, nt = -(-P // 16), -(-N // 16) * 2
    wm = 1
    while wm < mt:
        wm *= 2
    nw = state_tiles_per_warp(P, N)
    assert nw % 2 == 0 and nw <= 16
    owners = {}
    for warp in range(8):
        m, n0 = warp % wm, (warp // wm) * nw
        if m >= mt:
            continue
        for n in range(n0, min(n0 + nw, nt)):
            owners.setdefault((m, n), []).append(warp)
    assert sorted(owners) == [(m, n) for m in range(mt) for n in range(nt)]
    assert all(len(w) == 1 for w in owners.values())


ZERO_COUNTS = {"flash_attention": 0, "flash_attention_bwd": 0,
               "decode_attention": 0, "ssd_scan": 0, "ssd_scan_bwd": 0,
               "rglru_scan": 0, "rglru_scan_bwd": 0}


def test_cpu_calls_leave_launch_counters_at_zero():
    ops.reset_launch_counts()
    rng = np.random.default_rng(9)
    q = torch.from_numpy(rng.standard_normal((1, 8, 4, 16), dtype=np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 8, 2, 16), dtype=np.float32))
    ops.flash_attention(q, k, k)
    ops.decode_attention(q[:, 0], k, k, torch.tensor([3], dtype=torch.int32))
    ops.ssd(*(t for _, t in _ssd_inputs(rng, 1, 8, 2, 4, 1, 8,
                                        "float32")[:5]), chunk=4)
    ops.rglru(*(t for _, t in _rglru_inputs(rng, 1, 8, 4, "float32")[:4]))
    assert ops.launch_counts() == ZERO_COUNTS


def test_kernel_wrappers_refuse_cpu_tensors():
    q = torch.zeros((1, 8, 4, 64), dtype=torch.bfloat16)
    k = torch.zeros((1, 8, 2, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, k, k)
    with pytest.raises(ValueError, match="CUDA"):
        decode_attention_cuda(q[:, 0], k, k,
                              torch.tensor([3], dtype=torch.int32))
    rng = np.random.default_rng(10)
    x, dt, A, Bm, Cm, _ = (t for _, t in _ssd_inputs(rng, 1, 8, 2, 4, 1, 8,
                                                     "bfloat16"))
    with pytest.raises(ValueError, match="CUDA"):
        ssd_cuda(x, dt, A, Bm, Cm, chunk=4)
    x, ga, gi, la, _ = (t for _, t in _rglru_inputs(rng, 1, 8, 4,
                                                    "bfloat16"))
    with pytest.raises(ValueError, match="CUDA"):
        rglru_cuda(x, ga.float(), gi.float(), la)
    assert ops.launch_counts() == ZERO_COUNTS


def test_unknown_backend_raises():
    q = torch.zeros((1, 2, 2, 8))
    with pytest.raises(ValueError, match="backend"):
        ops.flash_attention(q, q, q, backend="xla")
    with pytest.raises(ValueError, match="backend"):
        ops.rglru(q[0], q[0], q[0], q[0, 0, 0], backend="pallas")
