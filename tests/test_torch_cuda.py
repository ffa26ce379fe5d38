"""The port's CUDA kernels against their plain versions, on the card (the
backwards of flash, the SSD scan and the RG-LRU scan too, and all three
under autograd); also the MLA layer through flash at full width against
its plain route, the MoE dispatch and combine (and their backwards) on
the card bitwise equal run to run and to the CPU's, one executor-sweep
cell, one recurrentgemma-2b train step at three layers, full-width
whisper-large-v3 and pixtral-12b at two layers against their plain
route, and the serving example at its full-width default.

Marked ``cuda``; each test skips where there is no CUDA device.  On a
GPU machine::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Inputs are bf16 (the scans' dt, A, gates and states fp32, as the models
feed them); the plain versions run in float32 on the same values.
Tolerance |kernel - plain| <= tol + tol |plain|: the kernels round
probabilities (flash) and outputs to bf16, ~0.4% relative each; tol is
the bf16 tolerance of ``tests/test_kernels.py``, 2e-2 for attention and
3e-2 for the scans.
"""

import ctypes

import pytest
import torch

from repro_torch import intra_op_threads
from repro_torch.configs import ARCHS, get_arch
from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import (
    _lib as decode_lib,
    counters as decode_counters,
    decode_attention_cuda,
    decode_attention_plain,
    plan as decode_plan,
)
from repro_torch.kernels.flash_attention import (
    flash_attention_cuda,
    flash_attention_plain,
)
from repro_torch.kernels.rglru_scan import rglru_cuda, rglru_plain
from repro_torch.kernels.ssd_scan import (
    _lib as ssd_lib,
    smem_bytes as ssd_smem_bytes,
    ssd_cuda,
    ssd_plain,
)
from repro_torch.models import lm, mla


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The module's CPU work on one intra-op thread: its small products
    would wake every thread, which under the suite's parallel workers
    makes them many times slower (the rule of ``README.md``'s "Tests on
    the CPU")."""
    with intra_op_threads(1):
        yield


pytestmark = pytest.mark.cuda
TOL = 2e-2
SCAN_TOL = 3e-2


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    return g


def _randn(gen, *shape):
    return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)


def _close(got, want, tol=TOL):
    assert got.shape == want.shape and torch.isfinite(got).all()
    diff = (got.float() - want.float()).abs()
    assert bool((diff <= tol + tol * want.float().abs()).all()), \
        float(diff.max())


FLASH = [
    # (B, Sq, Sk, H, KV, D, Dv, mask_kind, window, q_offset)
    (1, 64, 64, 2, 2, 64, 64, "causal", 0, 0),
    (2, 100, 100, 8, 2, 128, 128, "causal", 0, 0),
    (1, 37, 129, 4, 1, 128, 128, "none", 0, 0),
    (2, 50, 130, 4, 4, 64, 64, "causal", 0, 80),
    (1, 300, 300, 4, 2, 128, 128, "window", 33, 0),
    (1, 65, 65, 2, 1, 128, 64, "causal", 0, 0),
    (1, 65, 65, 2, 1, 64, 128, "window", 64, 0),
    (1, 8, 8, 2, 2, 64, 64, "window", 2, 20),    # rows see no key: zeros
    (2, 130, 130, 10, 1, 256, 256, "window", 2048, 0),   # recurrentgemma
    (1, 77, 150, 4, 2, 256, 256, "causal", 0, 73),
    (1, 200, 200, 2, 1, 256, 256, "window", 50, 0),
    # B > 1, Sq and Sk no multiple of 64: the tensor maps must zero-fill
    # each batch's ragged edge, not read the next batch's rows.
    (3, 77, 190, 4, 2, 64, 64, "none", 0, 0),
    (2, 150, 201, 8, 2, 128, 128, "causal", 0, 51),
    (3, 99, 99, 4, 1, 256, 256, "causal", 0, 0),
    # Sq <= 64: the second warpgroup's rows all lie past Sq.
    (2, 40, 300, 4, 2, 64, 64, "causal", 0, 260),
    (2, 33, 33, 4, 4, 128, 128, "causal", 0, 0),
    (2, 50, 100, 2, 1, 256, 256, "none", 0, 0),
    # Sk = 1, and Sk = 0 (every row is 0).
    (2, 5, 1, 4, 2, 64, 64, "none", 0, 0),
    (2, 3, 1, 4, 4, 128, 128, "causal", 0, 0),
    (1, 4, 1, 2, 1, 256, 256, "window", 4, 0),
    (2, 5, 0, 4, 2, 64, 64, "none", 0, 0),
    # G = 1 (H = KV).
    (1, 130, 130, 3, 3, 64, 64, "window", 40, 0),
    (2, 200, 200, 4, 4, 128, 128, "causal", 0, 0),
    (1, 100, 100, 2, 2, 256, 256, "causal", 0, 0),
    # A window whose first visible key tile is odd: the two-stage K/V ring
    # starts away from stage 0 (first tiles 3 and 4; 1, 2 and 3; 3 and 5).
    (1, 130, 1200, 2, 1, 64, 64, "window", 600, 1050),
    (2, 300, 600, 4, 2, 128, 128, "window", 150, 300),
    (1, 200, 500, 2, 1, 256, 256, "window", 100, 300),
    # MLA, deepseek-v2-lite's (192, 128): D is three TMA boxes.  Full
    # heads, ragged S, q_offset, a window, the ring phase, Sk = 1.
    (2, 1000, 1000, 16, 16, 192, 128, "causal", 0, 0),
    (1, 200, 333, 16, 16, 192, 128, "causal", 0, 133),
    (2, 300, 300, 4, 4, 192, 128, "window", 50, 0),
    (1, 200, 500, 2, 1, 192, 128, "window", 100, 300),
    (2, 5, 1, 4, 4, 192, 128, "none", 0, 0),
    # Sq 1 over a whole sequence, no mask: whisper-large-v3's cross
    # attention in every decode step (20 heads over 20 of 64), at G 4 and
    # over a ragged Sk.  127 of the query tile's 128 rows lie past Sq.
    (2, 1, 1536, 20, 20, 64, 64, "none", 0, 0),
    (2, 1, 1536, 8, 2, 128, 128, "none", 0, 0),
    (2, 1, 1537, 20, 20, 64, 64, "none", 0, 0),
    # The reduced configs' head dim 32 (and reduced MLA's (64, 32)), on
    # the (64, 64) tiles with the columns past 32 read as zeros: a serve
    # prompt, recurrentgemma's window 64, whisper's 32 frames through the
    # encoder and cross attention at Sq 1, ragged edges with a q_offset.
    (1, 8, 8, 4, 2, 32, 32, "causal", 0, 0),
    (1, 130, 130, 4, 1, 32, 32, "window", 64, 0),
    (2, 32, 32, 4, 4, 32, 32, "none", 0, 0),
    (2, 1, 32, 4, 4, 32, 32, "none", 0, 0),
    (3, 77, 150, 4, 2, 32, 32, "causal", 0, 73),
    (2, 300, 600, 4, 2, 32, 32, "window", 150, 300),
    (2, 5, 0, 4, 2, 32, 32, "none", 0, 0),
    (2, 100, 100, 4, 4, 64, 32, "causal", 0, 0),
    (1, 77, 190, 4, 2, 64, 32, "none", 0, 0),
]


@pytest.mark.parametrize("case", FLASH, ids=str)
def test_flash_kernel_matches_plain(case, gen):
    B, Sq, Sk, H, KV, D, Dv, kind, window, off = case
    q, k, v = _randn(gen, B, Sq, H, D), _randn(gen, B, Sk, KV, D), \
        _randn(gen, B, Sk, KV, Dv)
    kw = dict(mask_kind=kind, window=window, q_offset=off)
    got = flash_attention_cuda(q, k, v, **kw)
    again = flash_attention_cuda(q, k, v, **kw)
    want = flash_attention_plain(q.float(), k.float(), v.float(), **kw)
    torch.cuda.synchronize()
    _close(got, want)
    assert torch.equal(got, again), "two launches on one input differ"


DECODE = [
    # (B, S, H, KV, D, Dv, lengths)
    (1, 8, 2, 2, 64, 64, [8]),
    (4, 1096, 32, 4, 128, 128, [1, 300, 777, 1096]),
    (3, 200, 8, 8, 128, 128, [64, 65, 129]),
    (2, 70, 16, 1, 64, 128, [0, 70]),
    (4, 2048, 10, 1, 256, 256, [1, 1024, 1096, 2048]),   # recurrentgemma
    # Lengths shorter than n_split (33 here): CTAs with no keys arrive at
    # the combine with l = 0; a row of length 0 is zeros.
    (4, 2048, 10, 1, 256, 256, [1, 2, 3, 0]),
    # B * KV = 64: more (b, kv head) counters than one block's worth.
    (8, 300, 64, 8, 128, 128, [1, 37, 64, 100, 150, 200, 299, 300]),
    # G = 5: passes of 4 heads and of 1.
    (2, 500, 5, 1, 128, 128, [499, 33]),
    # The reduced configs' (32, 32) at G 1, 2 and 4: a serve batch's cache
    # (prompt 8 + 16 tokens + 8 slots), recurrentgemma's 64-slot window
    # (B 1: two splits of 32 keys) and lengths 0 and 64.
    (2, 32, 4, 4, 32, 32, [0, 17]),
    (3, 64, 4, 2, 32, 32, [64, 1, 33]),
    (1, 64, 4, 1, 32, 32, [64]),
    (2, 64, 4, 1, 32, 32, [0, 64]),
]


@pytest.mark.parametrize("case", DECODE, ids=str)
def test_decode_kernel_matches_plain(case, gen):
    B, S, H, KV, D, Dv, lens = case
    q = _randn(gen, B, H, D)
    kc, vc = _randn(gen, B, S, KV, D), _randn(gen, B, S, KV, Dv)
    length = torch.tensor(lens, dtype=torch.int32, device="cuda")
    got = decode_attention_cuda(q, kc, vc, length)
    again = decode_attention_cuda(q, kc, vc, length)
    want = decode_attention_plain(q.float(), kc.float(), vc.float(), length)
    torch.cuda.synchronize()
    _close(got, want)
    assert torch.equal(got, again), "two launches on one input differ"
    assert not decode_counters(q.device).any(), "counters left non-zero"


def test_decode_plan_matches_the_kernel_shared_memory(gen):
    lib = decode_lib()
    lib.decode_attention_smem.restype = ctypes.c_longlong
    for S, D, Dv, G, bkv in [(1096, 128, 128, 8, 16), (2048, 256, 256, 10, 4),
                             (70, 64, 128, 16, 2), (300, 128, 128, 8, 64),
                             (8, 64, 64, 1, 1), (64, 32, 32, 4, 1)]:
        n_split, smem = decode_plan(S, D, Dv, G, bkv, 132)
        assert lib.decode_attention_smem(S, D, Dv, G, n_split) == smem


def test_decode_refuses_views_that_are_not_16_byte_aligned(gen):
    q = _randn(gen, 2, 4, 64)
    flat = _randn(gen, 2 * 16 * 2 * 64 + 2)
    k = flat[2:].view(2, 16, 2, 64)            # 4 bytes past the allocation
    assert k.is_contiguous() and k.data_ptr() % 16
    length = torch.tensor([5, 16], dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="16-byte aligned"):
        decode_attention_cuda(q, k, k.clone(), length)
    with pytest.raises(ValueError, match="16-byte aligned"):
        decode_attention_cuda(flat[2:2 + 2 * 4 * 64].view(2, 4, 64),
                              k.clone(), k.clone(), length)
    with pytest.raises(ValueError, match="head dims"):
        decode_attention_cuda(_randn(gen, 2, 4, 96), _randn(gen, 2, 16, 2, 96),
                              _randn(gen, 2, 16, 2, 96), length)


SSD = [
    # (B, S, H, P, G, N, chunk, initial_state)
    (1, 64, 4, 32, 2, 64, 64, False),        # G > 1, S = chunk
    (3, 320, 8, 64, 4, 128, 64, True),       # several chunks, resumed
    (1, 96, 3, 24, 1, 40, 48, True),         # ragged tiles
    (2, 256, 4, 64, 1, 128, 128, False),     # the mamba2-2.7b head shape
    (4, 1024, 80, 64, 1, 128, 128, False),   # mamba2-2.7b's serve prefill
    (2, 64, 8, 32, 1, 32, 16, False),        # reduced mamba2-2.7b
    (1, 16, 8, 32, 1, 32, 16, True),
    # P and N no multiple of 8 (plain loads, not 16-byte copies); P odd.
    (2, 96, 3, 21, 1, 35, 48, True),
    # Q no multiple of 16; Q > 128 (two row tiles for some warps); Q 256.
    (1, 80, 2, 32, 1, 48, 40, True),
    (1, 400, 2, 64, 1, 64, 200, True),
    (1, 512, 2, 32, 1, 32, 256, False),
    # The widest states the registers take: 16 n8 tiles a warp; P 128.
    (1, 128, 2, 64, 1, 256, 64, True),
    (1, 128, 2, 128, 1, 64, 64, True),
]


def _ssd_inputs(gen, B, S, H, P, G, N, init, decay=1.0):
    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    x = (randn(B, S, H, P) * 0.5).to(torch.bfloat16)
    dt = torch.nn.functional.softplus(randn(B, S, H))
    A = -torch.exp(randn(H)) * decay
    Bm = (randn(B, S, G, N) * 0.3).to(torch.bfloat16)
    Cm = (randn(B, S, G, N) * 0.3).to(torch.bfloat16)
    h0 = randn(B, H, P, N) * 0.2 if init else None
    return x, dt, A, Bm, Cm, h0


@pytest.mark.parametrize("case", SSD, ids=str)
def test_ssd_kernel_matches_plain(case, gen):
    B, S, H, P, G, N, chunk, init = case
    x, dt, A, Bm, Cm, h0 = _ssd_inputs(gen, B, S, H, P, G, N, init)
    y, state = ssd_cuda(x, dt, A, Bm, Cm, chunk=chunk, initial_state=h0)
    again = ssd_cuda(x, dt, A, Bm, Cm, chunk=chunk, initial_state=h0)
    want_y, want_state = ssd_plain(x.float(), dt, A, Bm.float(), Cm.float(),
                                   chunk=chunk, initial_state=h0)
    torch.cuda.synchronize()
    _close(y, want_y, SCAN_TOL)
    _close(state, want_state, SCAN_TOL)
    assert torch.equal(y, again[0]) and torch.equal(state, again[1]), \
        "two launches on one input differ"


def test_ssd_kernel_survives_strong_decay(gen):
    """A dt << 0: exp(cum) underflows to 0 within a few steps, and the
    masked exponents above the diagonal would overflow; no NaN may come of
    either."""
    x, dt, A, Bm, Cm, h0 = _ssd_inputs(gen, 2, 256, 4, 64, 1, 128, True,
                                       decay=300.0)
    y, state = ssd_cuda(x, dt, A, Bm, Cm, chunk=128, initial_state=h0)
    want_y, want_state = ssd_plain(x.float(), dt, A, Bm.float(), Cm.float(),
                                   chunk=128, initial_state=h0)
    torch.cuda.synchronize()
    assert not torch.isnan(y).any() and not torch.isnan(state).any()
    _close(y, want_y, SCAN_TOL)
    _close(state, want_state, SCAN_TOL)


def test_ssd_smem_mirror_matches_the_kernel(gen):
    lib = ssd_lib()
    for Q, P, N in [(128, 64, 128), (48, 24, 40), (64, 32, 64), (16, 16, 16),
                    (200, 64, 64), (256, 64, 256), (40, 21, 35)]:
        assert lib.ssd_scan_smem_bytes(Q, P, N) == ssd_smem_bytes(Q, P, N)


RGLRU = [
    # (B, S, C, initial_state)
    (1, 16, 128, False),
    (2, 300, 384, True),      # S not a multiple of 256
    (3, 77, 100, False),      # C not a multiple of the block
    (4, 1024, 2560, False),   # the recurrentgemma-2b prefill shape
    (1, 1024, 2560, False),   # one request's prefill at full width
    # TMA route with ragged edges: C a multiple of 8 but not of the 32-
    # channel tile, S not a multiple of the 64-step chunk.
    (2, 333, 200, True),
]


def _rglru_inputs(gen, B, S, C, init, decay=1.0):
    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    x = (randn(B, S, C) * 0.5).to(torch.bfloat16)
    ga, gi = torch.sigmoid(randn(B, S, C)), torch.sigmoid(randn(B, S, C))
    la = -torch.nn.functional.softplus(randn(C)) * decay
    return x, ga, gi, la, randn(B, C) if init else None


@pytest.mark.parametrize("case", RGLRU, ids=str)
def test_rglru_kernel_matches_plain(case, gen):
    """h and the final state within SCAN_TOL of the plain scan, and
    bitwise the same with the entering states asked for, which are within
    SCAN_TOL of the plain forward's; two launches bitwise equal."""
    x, ga, gi, la, h0 = _rglru_inputs(gen, *case)
    h, state = rglru_cuda(x, ga, gi, la, initial_state=h0)
    again = rglru_cuda(x, ga, gi, la, initial_state=h0, entering=True)
    want_h, want_state, want_entering = rglru_plain(
        x.float(), ga, gi, la, initial_state=h0, entering=True)
    torch.cuda.synchronize()
    _close(h, want_h, SCAN_TOL)
    _close(state, want_state, SCAN_TOL)
    _close(again[2], want_entering, SCAN_TOL)
    assert torch.equal(h, again[0]) and torch.equal(state, again[1]), \
        "two launches on one input differ"


@pytest.mark.parametrize("kind", ["strong decay", "near one"])
def test_rglru_kernel_survives_extreme_decays(kind, gen):
    """log_a x 100: each sub-segment's product of a underflows to 0 (and a
    itself); gate_a ~ 0: a ~ 1 and beta ~ 0.  No NaN may come of either."""
    x, ga, gi, la, h0 = _rglru_inputs(gen, 2, 300, 256, True,
                                      decay=100.0 if kind == "strong decay"
                                      else 1.0)
    if kind == "near one":
        ga = ga * 1e-6
    h, state = rglru_cuda(x, ga, gi, la, initial_state=h0)
    want_h, want_state = rglru_plain(x.float(), ga, gi, la, initial_state=h0)
    torch.cuda.synchronize()
    assert not torch.isnan(h).any() and not torch.isnan(state).any()
    _close(h, want_h, SCAN_TOL)
    _close(state, want_state, SCAN_TOL)


@pytest.mark.parametrize("C", [256, 100], ids=["C256", "C100"])
def test_rglru_kernel_takes_an_empty_sequence(C, gen):
    """S 0: h is empty and the state is the initial state, or zeros."""
    x, ga, gi, la, h0 = _rglru_inputs(gen, 2, 0, C, True)
    h, state = rglru_cuda(x, ga, gi, la, initial_state=h0)
    _, zeros = rglru_cuda(x, ga, gi, la)
    torch.cuda.synchronize()
    assert h.shape == (2, 0, C)
    assert torch.equal(state, h0) and not zeros.any()


def test_ops_route_cuda_tensors_to_the_kernels(gen):
    ops.reset_launch_counts()
    q, k = _randn(gen, 1, 16, 4, 64), _randn(gen, 1, 16, 2, 64)
    ops.flash_attention(q, k, k)
    ops.decode_attention(q[:, 0].contiguous(), k, k,
                         torch.tensor([5], dtype=torch.int32, device="cuda"))
    ops.flash_attention(q, k, k, backend="ref")
    x, dt, A, Bm, Cm, _ = _ssd_inputs(gen, 1, 32, 2, 16, 1, 16, False)
    ops.ssd(x, dt, A, Bm, Cm, chunk=16)
    ops.ssd(x, dt, A, Bm, Cm, chunk=16, backend="ref")
    ops.rglru(*_rglru_inputs(gen, 1, 8, 16, False)[:4])
    torch.cuda.synchronize()
    assert ops.launch_counts() == {"flash_attention": 1,
                                   "flash_attention_bwd": 0,
                                   "decode_attention": 1, "ssd_scan": 1,
                                   "ssd_scan_bwd": 0, "rglru_scan": 1,
                                   "rglru_scan_bwd": 0}


def test_kernel_wrappers_refuse_what_the_kernels_do_not_take(gen):
    q, k = _randn(gen, 1, 16, 4, 64), _randn(gen, 1, 16, 2, 64)
    with pytest.raises(TypeError):
        flash_attention_cuda(q.float(), k.float(), k.float())
    with pytest.raises(ValueError, match="head dims"):
        flash_attention_cuda(_randn(gen, 1, 16, 4, 96),
                             _randn(gen, 1, 16, 2, 96),
                             _randn(gen, 1, 16, 2, 96))
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_cuda(q.transpose(1, 2), k, k)
    with pytest.raises(ValueError, match="length"):
        decode_attention_cuda(q[:, 0].contiguous(), k, k,
                              torch.tensor([5], device="cuda"))
    x, dt, A, Bm, Cm, _ = _ssd_inputs(gen, 1, 32, 2, 16, 1, 16, False)
    with pytest.raises(TypeError, match="dt"):
        ssd_cuda(x, dt.to(torch.bfloat16), A, Bm, Cm, chunk=16)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ssd_cuda(x, dt, A, Bm, Cm, chunk=24)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_cuda(x.transpose(2, 3).contiguous().transpose(2, 3), dt, A, Bm,
                 Cm, chunk=16)
    with pytest.raises(ValueError, match="shared memory"):
        ssd_cuda(*_ssd_inputs(gen, 1, 256, 1, 64, 1, 256, False)[:5],
                 chunk=256)
    with pytest.raises(ValueError, match="registers"):
        ssd_cuda(*_ssd_inputs(gen, 1, 16, 1, 64, 1, 512, False)[:5],
                 chunk=16)
    with pytest.raises(ValueError, match="head dims"):
        ssd_cuda(*_ssd_inputs(gen, 1, 16, 1, 256, 1, 16, False)[:5],
                 chunk=16)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_cuda(x.cpu(), dt, A, Bm, Cm, chunk=16)
    x, ga, gi, la, _ = _rglru_inputs(gen, 1, 8, 16, False)
    with pytest.raises(TypeError, match="gate_a"):
        rglru_cuda(x, ga.to(torch.bfloat16), gi, la)
    with pytest.raises(TypeError, match="x must be"):
        rglru_cuda(x.float(), ga, gi, la)
    with pytest.raises(ValueError, match="log_a"):
        rglru_cuda(x, ga, gi, la[:1])


# ------------------------------------------------------------------- MLA
@pytest.mark.parametrize("case", [
    # (B, Sq, Sk, q_offset, mask_kind, window): minicpm3-4b's 40 heads,
    # qk 96 zero-padded to 128, v 64, the scale of qk 96
    (2, 1000, 1000, 0, "causal", 0),
    (3, 200, 333, 133, "causal", 0),
    (2, 300, 300, 0, "window", 50),
], ids=str)
def test_flash_kernel_takes_minicpm3_padded_heads(case, gen):
    B, Sq, Sk, off, kind, window = case
    q, k, v = _randn(gen, B, Sq, 40, 96), _randn(gen, B, Sk, 40, 96), \
        _randn(gen, B, Sk, 40, 64)
    assert mla.padded_qk_dim(96, 64) == 128
    pad = [t.new_zeros(t.shape[:-1] + (32,)) for t in (q, k)]
    qp, kp = torch.cat([q, pad[0]], -1), torch.cat([k, pad[1]], -1)
    kw = dict(mask_kind=kind, window=window, q_offset=off, scale=96 ** -0.5)
    got = flash_attention_cuda(qp, kp, v, **kw)
    again = flash_attention_cuda(qp, kp, v, **kw)
    want = flash_attention_plain(q.float(), k.float(), v.float(), **kw)
    torch.cuda.synchronize()
    _close(got, want)
    assert torch.equal(got, again), "two launches on one input differ"


def _mla_layer(arch, gen, reduced=False):
    """One MLA layer's parameters at the arch's dims (random, bf16) and
    its config."""
    cfg = get_arch(arch).reduced() if reduced else get_arch(arch)
    shapes = lm.param_shapes(cfg)
    p = {}
    for key, (shape, how) in shapes.items():
        if not key.startswith("stage0/u0/mixer/"):
            continue
        name = key[len("stage0/u0/mixer/"):]
        if isinstance(how, str):            # the norms' scales
            p[name.split("/")[0]] = {"scale": torch.ones(
                shape[1:], device="cuda")}
        else:
            p[name] = (torch.randn(shape[1:], generator=gen, device="cuda")
                       * how).to(torch.bfloat16)
    return cfg, p


@pytest.mark.parametrize("arch", ["minicpm3-4b", "deepseek-v2-lite-16b"])
def test_mla_layer_through_the_kernel_matches_its_plain_route(arch, gen):
    """Full-width MLA prefill (flash at (128, 64) padded, or (192, 128))
    against the same layer through the plain attention; relative L2 of
    the output within the attention tolerance.  The cache does not pass
    through the kernel and is equal."""
    cfg, p = _mla_layer(arch, gen)
    x = _randn(gen, 2, 300, cfg.d_model)
    ops.reset_launch_counts()
    got, got_c = mla.mla_apply(p, x, cfg.mla, rope_theta=cfg.rope_theta)
    assert ops.launch_counts()["flash_attention"] == 1
    want, want_c = mla.mla_apply(p, x, cfg.mla, rope_theta=cfg.rope_theta,
                                 backend="ref")
    torch.cuda.synchronize()
    rel = float((got.float() - want.float()).norm() / want.float().norm())
    assert torch.isfinite(got).all() and rel < TOL, rel
    for name in ("c_kv", "k_rope"):
        assert torch.equal(got_c[name], want_c[name])


@pytest.mark.parametrize("arch", ["minicpm3-4b", "deepseek-v2-lite-16b"])
def test_mla_reduced_dims_match_the_plain_route_on_the_card(arch, gen):
    """The reduced configs' qk 48 / v 32 runs through flash as (64, 32)
    (q and k zero-padded to 64): the layer's output against its plain
    route within the attention tolerance, the cache equal."""
    cfg, p = _mla_layer(arch, gen, reduced=True)
    m = cfg.mla
    assert mla.padded_qk_dim(m.qk_nope_dim + m.qk_rope_dim,
                             m.v_head_dim) == 64
    x = _randn(gen, 2, 100, cfg.d_model)
    ops.reset_launch_counts()
    got, got_c = mla.mla_apply(p, x, m, rope_theta=cfg.rope_theta)
    assert ops.launch_counts()["flash_attention"] == 1
    want, want_c = mla.mla_apply(p, x, m, rope_theta=cfg.rope_theta,
                                 backend="ref")
    torch.cuda.synchronize()
    rel = float((got.float() - want.float()).norm() / want.float().norm())
    assert torch.isfinite(got).all() and rel < TOL, rel
    for name in ("c_kv", "k_rope"):
        assert torch.equal(got_c[name], want_c[name])


# ------------------------------------------------------------------- MoE
def test_moe_dispatch_and_combine_on_the_card_equal_the_cpu(gen):
    """The dispatch and the combine are gathers and in-order sums: the card
    gives the CPU's bits, run after run (deepseek-v2-lite's routing at
    B 2, S 300, with drops)."""
    B, T, D, E, K, cap = 2, 300, 256, 64, 6, 20
    x = _randn(gen, B, T, D)
    scores = torch.rand((B, T, E), generator=gen, device="cuda")
    idx = scores.argsort(dim=-1)[..., :K]
    gate = torch.rand((B, T, K), generator=gen, device="cuda").to(
        torch.bfloat16)
    buf, meta = ops.moe_dispatch(x, idx, gate, E, cap)
    cbuf, cmeta = ops.moe_dispatch(x.cpu(), idx.cpu(), gate.cpu(), E, cap)
    assert torch.equal(buf.cpu(), cbuf)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(meta, cmeta))
    y = _randn(gen, B, E, cap, D)
    out = ops.moe_combine(y, meta)
    again = ops.moe_combine(y, meta)
    assert torch.equal(out, again)
    assert torch.equal(out.cpu(), ops.moe_combine(y.cpu(), cmeta))


def test_moe_backward_on_the_card_repeats_and_equals_the_cpu(gen):
    """The backwards of the dispatch and the combine are gathers and
    in-order sums too (autograd's own backward of ``gather``, an atomic
    ``scatter_add``, summed a token's K rows in another order on every
    run): two backwards on the card give the same bits, and dx and dy are
    the CPU's bits (deepseek-v2-lite's routing at B 2, S 300, with
    drops)."""
    B, T, D, E, K, cap = 2, 300, 256, 64, 6, 20
    x = _randn(gen, B, T, D)
    scores = torch.rand((B, T, E), generator=gen, device="cuda")
    idx = scores.argsort(dim=-1)[..., :K]
    gate = torch.rand((B, T, K), generator=gen, device="cuda").to(
        torch.bfloat16)
    y, dout = _randn(gen, B, E, cap, D), _randn(gen, B, T, D)

    def grads(x, idx, gate, y, dout):
        x, gate, y = (t.detach().requires_grad_() for t in (x, gate, y))
        buf, meta = ops.moe_dispatch(x, idx, gate, E, cap)
        out = ops.moe_combine(buf + y, meta)
        return torch.autograd.grad(out, (x, gate, y), dout)

    got = grads(x, idx, gate, y, dout)
    again = grads(x, idx, gate, y, dout)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    cpu = grads(*(t.cpu() for t in (x, idx, gate, y, dout)))
    assert torch.equal(got[0].cpu(), cpu[0])
    assert torch.equal(got[2].cpu(), cpu[2])


# ------------------------------------------------------- executor bridge
def test_executor_cell_runs_on_the_card(gen, tmp_path):
    """One executor-sweep cell with no device given: its synthetic blocks
    run on the card, every job finishes, and the solo baselines are keyed
    by the device."""
    from repro_torch.core import scenarios, sweep
    from repro_torch.core.workload import ERCBENCH, scaled_spec

    specs = {"SAD": scaled_spec(ERCBENCH["SAD"], num_blocks=8,
                                mean_t=30_000.0),
             "JPEG-d": scaled_spec(ERCBENCH["JPEG-d"], num_blocks=4,
                                   mean_t=900.0)}
    scn = scenarios.TraceReplay(trace=[{"kernel": "SAD", "time": 0.0},
                                       {"kernel": "JPEG-d", "time": 100.0}],
                                specs=specs, name="card")
    spec = sweep.SweepSpec(scenarios=(scn,), policies=("srtf",),
                           machine="executor", n_sm=3)
    assert spec.device == "cuda"
    cell, = sweep.run_sweep(spec, cache_dir=tmp_path).cells
    assert cell.measured and not cell.unfinished
    assert cell.window.n_finished == 2 and cell.metrics.stp > 0.0
    key = sweep._executor_solo_key(specs["SAD"], 3, 1, "cuda")
    assert (tmp_path / f"{key}.json").exists()
    step, x0 = scenarios._synthetic_block(61, 4, torch.device("cuda"))
    assert step(x0).is_cuda


# -------------------------------------------------------- serving example
def test_concurrent_serving_example_at_full_width_on_the_card(gen,
                                                              monkeypatch):
    """The example's default: full-width minicpm3-4b and yi-6b on the
    card (16-token prompts, flash and decode at those shapes); every job
    of every run finishes all its blocks."""
    from repro_torch.core.executor import LaneExecutor
    from repro_torch.examples import concurrent_serving

    runs = []

    class Recording(LaneExecutor):
        def run(self, *args, **kwargs):
            results = super().run(*args, **kwargs)
            runs.append({k: (r.blocks, r.cancelled)
                         for k, r in results.items()})
            return results

    monkeypatch.setattr(concurrent_serving, "LaneExecutor", Recording)
    ops.reset_launch_counts()
    out = concurrent_serving.main([])
    assert sorted(out) == ["fifo", "srtf", "srtf-adaptive"]
    assert all(m.stp > 0 and m.antt > 0 for m in out.values())
    # Two solo runs, then one run of both jobs per policy.
    assert [len(r) for r in runs] == [1, 1, 2, 2, 2]
    for r in runs:
        for key, (blocks, cancelled) in r.items():
            assert blocks == (40 if key.startswith("long-job") else 5)
            assert not cancelled
    launches = ops.launch_counts()
    assert launches["flash_attention"] > 0
    assert launches["decode_attention"] > 0


# ------------------------------------------------------------- training
BWD = [
    # (B, Sq, Sk, H, KV, D, mask_kind, window, q_offset)
    (4, 1024, 1024, 32, 4, 128, "causal", 0, 0),         # yi-6b training
    (8, 128, 128, 10, 2, 64, "causal", 0, 0),            # the 100M example
    (2, 1000, 1000, 8, 2, 128, "causal", 0, 0),          # ragged S
    (2, 150, 201, 8, 2, 128, "causal", 0, 51),           # Sq != Sk, offset
    (1, 300, 300, 4, 2, 128, "window", 33, 0),
    (2, 300, 600, 4, 2, 64, "window", 150, 300),         # window + offset
    (1, 37, 129, 4, 1, 128, "none", 0, 0),
    (3, 77, 190, 4, 2, 64, "none", 0, 0),
    (2, 40, 300, 4, 2, 64, "causal", 0, 260),            # Sq < one tile
    (2, 5, 1, 4, 2, 64, "none", 0, 0),                   # Sk = 1
    (1, 8, 8, 2, 2, 64, "window", 2, 20),                # no key in sight
    (2, 5, 0, 4, 2, 64, "none", 0, 0),                   # Sk = 0
    (2, 200, 200, 4, 4, 128, "causal", 0, 0),            # G = 1
    # The ring wraps many times, odd step counts split between the two
    # warpgroups of the dK/dV kernel.
    (1, 2048, 2048, 8, 1, 64, "causal", 0, 0),           # D 64, G 8
    (2, 1000, 1000, 8, 2, 128, "window", 150, 0),        # ragged, window
    # (256, 256), the wide kernels: recurrentgemma-2b's local layers at
    # their training shape (MQA, window 2048 >= S), a window shorter than
    # S, ragged S with a q_offset, no mask with Sq != Sk, no key in sight,
    # G 1 and an odd step count.
    (4, 1024, 1024, 10, 1, 256, "window", 2048, 0),
    (1, 300, 300, 5, 1, 256, "window", 100, 0),
    (2, 150, 201, 4, 2, 256, "causal", 0, 51),
    (1, 77, 190, 4, 1, 256, "none", 0, 0),
    (1, 8, 8, 2, 2, 256, "window", 2, 20),
    (2, 5, 0, 4, 2, 256, "none", 0, 0),
    (1, 200, 200, 3, 3, 256, "causal", 0, 0),
    # whisper-large-v3's cross attention, short: no mask, Sq 100 over its
    # 1536 frames, G 1
    (2, 100, 1536, 4, 4, 64, "none", 0, 0),
    # The reduced configs' head dim 32 (the split kernels on (64, 64)
    # tiles): the quickstart's batch, recurrentgemma's window 64, whisper's
    # encoder and cross attention over 32 frames, ragged S with a
    # q_offset, an odd step count, no key in sight and Sk = 0.
    (4, 64, 64, 4, 2, 32, "causal", 0, 0),
    (2, 200, 200, 4, 1, 32, "window", 64, 0),
    (4, 32, 32, 4, 4, 32, "none", 0, 0),
    (4, 56, 32, 4, 4, 32, "none", 0, 0),
    (2, 150, 201, 4, 2, 32, "causal", 0, 51),
    (1, 1000, 1000, 4, 1, 32, "causal", 0, 0),
    (1, 8, 8, 2, 2, 32, "window", 2, 20),
    (2, 5, 0, 4, 2, 32, "none", 0, 0),
]
# Backward, kernel vs the plain formula in fp32: relative L2 of each
# gradient within max(2e-2, 2 x floor), the floor the plain formula in
# bf16 (P and dS rounded before the products, as the kernel rounds them).
BWD_REL_L2 = 2e-2


def _rel_l2(got, want):
    want = want.float()
    return float((got.float() - want).norm() / want.norm().clamp(min=1e-30))


@pytest.mark.parametrize("case", BWD, ids=str)
def test_flash_backward_kernel_matches_plain(case, gen):
    B, Sq, Sk, H, KV, D, kind, window, off = case
    _check_backward(gen, B, Sq, Sk, H, KV, D, D, D, kind, window, off)


BWD_MLA = [
    # (B, Sq, Sk, H, KV, qk, D, Dv, mask_kind, window, q_offset): q and k
    # of width qk zero-padded to D, as mla_apply pads them, at the scale
    # of qk.  minicpm3-4b's training shape (40 heads, qk 96 run as 128, v
    # 64) and deepseek-v2-lite's (16 heads of (192, 128)), then ragged S
    # with a q_offset, no mask with Sq != Sk, G > 1 and a window.
    (4, 1024, 1024, 40, 40, 96, 128, 64, "causal", 0, 0),
    (4, 1024, 1024, 16, 16, 192, 192, 128, "causal", 0, 0),
    (2, 150, 201, 8, 8, 96, 128, 64, "causal", 0, 51),
    (2, 150, 201, 4, 4, 192, 192, 128, "causal", 0, 51),
    (1, 77, 190, 4, 2, 128, 128, 64, "none", 0, 0),
    (1, 77, 190, 4, 2, 192, 192, 128, "none", 0, 0),
    (1, 300, 300, 6, 2, 192, 192, 128, "window", 100, 0),
    (1, 8, 8, 2, 2, 192, 192, 128, "window", 2, 20),     # no key in sight
    # Reduced MLA: qk 48 run as 64 beside v 32 (the split kernels on
    # (64, 64) tiles, v's columns past 32 read as zeros), 4 heads over 4.
    (4, 64, 64, 4, 4, 48, 64, 32, "causal", 0, 0),
    (2, 150, 201, 4, 4, 48, 64, 32, "causal", 0, 51),
    (1, 77, 190, 4, 2, 48, 64, 32, "none", 0, 0),
]


@pytest.mark.parametrize("case", BWD_MLA, ids=str)
def test_flash_backward_kernel_matches_plain_at_mla_pairs(case, gen):
    _check_backward(gen, *case)


def _check_backward(gen, B, Sq, Sk, H, KV, qk, D, Dv, kind, window, off):
    """The kernel against the plain formula in fp32 (relative L2 within
    max(2e-2, 2 x floor)), two launches bitwise equal; q and k of width
    ``qk`` zero-padded to D, at the scale of qk; the padded columns of dq
    and dk come out zero."""
    from repro_torch.kernels.flash_attention_bwd import (
        flash_attention_bwd_cuda,
        flash_attention_bwd_plain,
    )

    def padded(t):
        return torch.cat([t, t.new_zeros(t.shape[:-1] + (D - qk,))], -1)

    q, k = padded(_randn(gen, B, Sq, H, qk)), padded(_randn(gen, B, Sk, KV,
                                                            qk))
    v, dout = _randn(gen, B, Sk, KV, Dv), _randn(gen, B, Sq, H, Dv)
    kw = dict(mask_kind=kind, window=window, q_offset=off,
              scale=qk ** -0.5)
    out, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
    got = flash_attention_bwd_cuda(q, k, v, out, dout, lse, **kw)
    again = flash_attention_bwd_cuda(q, k, v, out, dout, lse, **kw)
    want = flash_attention_bwd_plain(q, k, v, out, dout, lse, **kw)
    floor = flash_attention_bwd_plain(q, k, v, out, dout, lse,
                                      dtype=torch.bfloat16, **kw)
    torch.cuda.synchronize()
    for name, g, a, w, f in zip(("dq", "dk", "dv"), got, again, want, floor):
        assert g.shape == w.shape and g.dtype == torch.bfloat16, name
        assert torch.isfinite(g).all(), name
        assert torch.equal(g, a), f"{name}: two launches differ"
        if not w.any():
            assert not g.any(), name
            continue
        limit = max(BWD_REL_L2, 2 * _rel_l2(f, w))
        assert _rel_l2(g, w) <= limit, (name, _rel_l2(g, w), limit)
    for g in got[:2]:
        assert not g[..., qk:].any(), "padded columns"


def test_flash_backward_smem_bytes_match_the_source(gen):
    """The wrapper module's mirror of the two product kernels' shared
    memory equals the source's layouts, which fit the card."""
    from repro_torch.kernels.flash_attention_bwd import (
        HEAD_DIMS as BWD_HEAD_DIMS,
        _lib as bwd_lib,
        smem_bytes as bwd_smem_bytes,
    )

    lib = bwd_lib()
    for D, Dv in BWD_HEAD_DIMS:
        got = tuple(lib.flash_attention_bwd_smem_bytes(D, Dv, kernel)
                    for kernel in (0, 1))
        assert got == bwd_smem_bytes(D, Dv)
        assert max(got) <= 232_448
    # the forward's (64, 128) has no backward
    assert lib.flash_attention_bwd_smem_bytes(64, 128, 0) == -1


def test_wide_flash_backward_holds_one_cta_an_sm(gen):
    """The wide kernels' shared memory (dK/dV's two-stage ring, dQ's K and
    V rings) leaves one CTA of each an SM at both wide pairs, as their
    mirrors say."""
    from repro_torch.kernels.flash_attention_bwd import (
        WIDE_PAIRS,
        smem_bytes,
        wide_ctas,
    )

    for D, Dv in WIDE_PAIRS:
        assert wide_ctas(torch.device("cuda", 0), D, Dv) == (1, 1)
        assert all(2 * b > 232_448 for b in smem_bytes(D, Dv))


@pytest.mark.parametrize("case", [c for c in FLASH if c[2] > 0], ids=str)
def test_flash_forward_gives_the_same_out_with_lse(case, gen):
    """Asking for the lse changes nothing the serving path reads; the lse
    is the plain one within 1e-3, and -1e30 for rows that see no key."""
    B, Sq, Sk, H, KV, D, Dv, kind, window, off = case
    q, k, v = _randn(gen, B, Sq, H, D), _randn(gen, B, Sk, KV, D), \
        _randn(gen, B, Sk, KV, Dv)
    kw = dict(mask_kind=kind, window=window, q_offset=off)
    alone = flash_attention_cuda(q, k, v, **kw)
    out, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
    _, want = flash_attention_plain(q.float(), k.float(), v.float(),
                                    return_lse=True, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, alone)
    assert lse.shape == (B, Sq, H) and lse.dtype == torch.float32
    assert float((lse - want).abs().max()) <= 1e-3


def test_flash_under_autograd_launches_both_kernels(gen):
    q, k, v = (t.requires_grad_() for t in (
        _randn(gen, 2, 64, 4, 64), _randn(gen, 2, 64, 2, 64),
        _randn(gen, 2, 64, 2, 64)))
    ops.reset_launch_counts()
    out = ops.flash_attention(q, k, v)
    out.float().sum().backward()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["flash_attention"] == 1
    assert counts["flash_attention_bwd"] == 1
    assert all(t.grad is not None and t.grad.dtype == torch.bfloat16
               for t in (q, k, v))


SSD_BWD = [
    # (B, S, H, P, G, N, chunk, initial_state, dstate, decay)
    (4, 1024, 80, 64, 1, 128, 128, False, False, 1.0),   # mamba2 training
    (2, 256, 8, 64, 2, 128, 64, True, True, 1.0),        # G 2, chunk 64
    (2, 64, 8, 32, 4, 64, 64, False, True, 1.0),         # S = chunk
    (2, 512, 4, 32, 1, 32, 256, True, False, 1.0),       # chunk 256
    (2, 256, 4, 64, 1, 128, 128, True, True, 300.0),     # strong decay
    (1, 96, 3, 24, 1, 40, 48, True, True, 1.0),          # ragged P, N, Q
    (1, 128, 2, 128, 1, 128, 64, True, True, 1.0),       # widest P and N
    (2, 32, 4, 32, 1, 32, 16, True, False, 1.0),         # reduced config's
    # P and N no multiple of 8: x, dy, B and C by plain loads, not TMA
    (1, 96, 3, 21, 1, 35, 48, True, True, 1.0),
    # 6 heads a group in slices of 4 (4 + 2) and of 8 (one slice of 6), the
    # heads a CTA takes (the last field) forced past the wrapper's plan.
    (2, 256, 12, 64, 2, 128, 128, True, True, 1.0, 4),
    (2, 256, 12, 64, 2, 128, 128, True, True, 1.0, 8),
]
# Backward, kernel vs the plain formula in fp32: relative L2 of each
# gradient within max(3e-2, 2 x floor), the floor the plain formula with
# bf16 product operands (as the kernel rounds them).
SSD_BWD_REL_L2 = 3e-2


@pytest.mark.parametrize("case", SSD_BWD, ids=str)
def test_ssd_backward_kernel_matches_plain(case, gen, monkeypatch):
    from repro_torch.kernels import ssd_scan_bwd
    from repro_torch.kernels.ssd_scan_bwd import ssd_bwd_cuda, ssd_bwd_plain

    B, S, H, P, G, N, chunk, init, dst, decay, *heads = case
    if heads:
        monkeypatch.setattr(ssd_scan_bwd, "plan", lambda *a, **k: heads[0])
    x, dt, A, Bm, Cm, h0 = _ssd_inputs(gen, B, S, H, P, G, N, init, decay)
    dy = _randn(gen, B, S, H, P)
    ds = torch.randn((B, H, P, N), generator=gen, device="cuda") * 0.5 \
        if dst else None
    kw = dict(chunk=chunk, initial_state=h0)
    got = ssd_bwd_cuda(x, dt, A, Bm, Cm, dy, ds, **kw)
    again = ssd_bwd_cuda(x, dt, A, Bm, Cm, dy, ds, **kw)
    want = ssd_bwd_plain(x, dt, A, Bm, Cm, dy, ds, **kw)
    floor = ssd_bwd_plain(x, dt, A, Bm, Cm, dy, ds, dtype=torch.bfloat16,
                          **kw)
    torch.cuda.synchronize()
    assert (got[5] is None) == (h0 is None)
    for name, g, a, w, f in zip(("dx", "ddt", "dA", "dB", "dC", "dh0"), got,
                                again, want, floor):
        if w is None:
            continue
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert torch.isfinite(g).all(), name
        assert torch.equal(g, a), f"{name}: two launches differ"
        if not w.any():
            assert not g.any(), name
            continue
        limit = max(SSD_BWD_REL_L2, 2 * _rel_l2(f, w))
        assert _rel_l2(g, w) <= limit, (name, _rel_l2(g, w), limit)


def test_ssd_backward_smem_bytes_match_the_source(gen):
    from repro_torch.kernels.ssd_scan_bwd import (
        _lib as bwd_lib,
        smem_bytes as bwd_smem_bytes,
    )

    lib = bwd_lib()
    for Q, P, N in [(128, 64, 128), (48, 24, 40), (64, 32, 64), (16, 16, 16),
                    (256, 32, 32), (128, 128, 128), (40, 21, 35)]:
        got = tuple(lib.ssd_scan_bwd_smem_bytes(Q, P, N, k) for k in (0, 1))
        assert got == bwd_smem_bytes(Q, P, N)


def test_ssd_backward_refuses_what_the_kernel_does_not_take(gen):
    from repro_torch.kernels.ssd_scan_bwd import ssd_bwd_cuda

    x, dt, A, Bm, Cm, _ = _ssd_inputs(gen, 1, 32, 2, 16, 1, 16, False)
    dy = _randn(gen, 1, 32, 2, 16)
    with pytest.raises(TypeError):
        ssd_bwd_cuda(x, dt, A, Bm, Cm, dy.float(), chunk=16)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ssd_bwd_cuda(x, dt, A, Bm, Cm, dy, chunk=24)
    with pytest.raises(ValueError, match="state dims"):
        ssd_bwd_cuda(*_ssd_inputs(gen, 1, 16, 1, 16, 1, 256, False)[:5],
                     _randn(gen, 1, 16, 1, 16), chunk=16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ssd_bwd_cuda(x, dt, A, Bm, Cm, dy.cpu(), chunk=16)
    # a prime chunk over 128 would run as sub-chunks of one row
    with pytest.raises(ValueError, match="at least 16 rows"):
        ssd_bwd_cuda(*_ssd_inputs(gen, 1, 131, 1, 16, 1, 16, False)[:5],
                     _randn(gen, 1, 131, 1, 16), chunk=131)


# Where the two warpgroups of a chunk-pass CTA share its rows (P = N =
# 128), where x, dy, B and C come by plain loads (P 21, N 35), and where a
# CTA's slice of heads is ragged: many launches on one input, each
# bitwise equal to the first (a race between the warpgroups shows as
# launches that differ now and then, not every time).
SSD_BWD_REPEAT = [
    # (B, S, H, P, G, N, chunk, heads a CTA or None for the wrapper's plan)
    (1, 128, 2, 128, 1, 128, 64, None),
    (2, 1024, 16, 128, 1, 128, 128, None),
    (1, 96, 3, 21, 1, 35, 48, None),
    (2, 256, 12, 64, 2, 128, 128, 4),
]


@pytest.mark.parametrize("case", SSD_BWD_REPEAT, ids=str)
def test_ssd_backward_launches_repeat_bitwise(case, gen, monkeypatch):
    from repro_torch.kernels import ssd_scan_bwd
    from repro_torch.kernels.ssd_scan_bwd import ssd_bwd_cuda

    B, S, H, P, G, N, chunk, heads = case
    if heads:
        monkeypatch.setattr(ssd_scan_bwd, "plan", lambda *a, **k: heads)
    x, dt, A, Bm, Cm, h0 = _ssd_inputs(gen, B, S, H, P, G, N, True)
    dy = _randn(gen, B, S, H, P)
    ds = torch.randn((B, H, P, N), generator=gen, device="cuda") * 0.5
    kw = dict(chunk=chunk, initial_state=h0)
    first = ssd_bwd_cuda(x, dt, A, Bm, Cm, dy, ds, **kw)
    names = ("dx", "ddt", "dA", "dB", "dC", "dh0")
    for k in range(200):
        again = ssd_bwd_cuda(x, dt, A, Bm, Cm, dy, ds, **kw)
        differ = [n for n, u, v in zip(names, first, again)
                  if not torch.equal(u, v)]
        assert not differ, f"launch {k + 2} differs from the first: {differ}"


def test_ssd_under_autograd_launches_both_kernels(gen):
    """Under grad, ops.ssd on CUDA tensors goes through SSDScan: one
    forward and one backward launch, gradients in the inputs' dtypes; with
    an initial state, its gradient too."""
    x, dt, A, Bm, Cm, h0 = _ssd_inputs(gen, 2, 64, 4, 32, 2, 32, True)
    leaves = [t.requires_grad_() for t in (x, dt, A, Bm, Cm, h0)]
    ops.reset_launch_counts()
    y, state = ops.ssd(*leaves[:5], chunk=32, initial_state=leaves[5])
    (y.float().sum() + state.sum()).backward()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["ssd_scan"] == 1 and counts["ssd_scan_bwd"] == 1
    assert [t.grad.dtype for t in leaves] == [
        torch.bfloat16, torch.float32, torch.float32, torch.bfloat16,
        torch.bfloat16, torch.float32]
    assert all(torch.isfinite(t.grad).all() for t in leaves)
    with torch.no_grad():
        ops.reset_launch_counts()
        ops.ssd(x, dt, A, Bm, Cm, chunk=32)
        assert ops.launch_counts()["ssd_scan_bwd"] == 0


RGLRU_BWD = [
    # (B, S, C, initial_state, dstate, log_a scale, gate_a scale)
    (4, 1024, 2560, False, False, 1.0, 1.0),     # recurrentgemma training
    (2, 130, 100, True, True, 1.0, 1.0),         # ragged C and S
    (3, 77, 35, False, True, 1.0, 1.0),
    # TMA route with ragged edges: C a multiple of 8 but not of the tile,
    # S not a multiple of the chunk
    (2, 333, 200, True, True, 1.0, 1.0),
    (2, 0, 256, True, True, 1.0, 1.0),           # S 0
    (2, 300, 256, True, True, 100.0, 1.0),       # strong decay
    (2, 300, 256, True, True, 1.0, 1e-3),        # gates near 0: beta small
    (1, 64, 32, True, False, 1.0, 1.0),          # one whole chunk
    # gate_a exactly 0 at a fifth of the steps: beta 0, beta's derivative
    # taken as 0 there
    (2, 300, 256, True, True, 1.0, 1.0, 0.2),
]
# RG-LRU backward, kernel vs the plain formula in fp32 on the same inputs:
# dx (bf16) within max(3e-2, 2 x floor) relative L2, the floor the plain
# dx rounded to bf16; the fp32 gradients (the gates, log_a and the initial
# state) within 1e-4, as on the CPU: the kernel recomputes h_{t-1} in fp32
# with the plain version's formula, so only the order of fp32 sums differs.
RGLRU_BWD_REL_L2 = 3e-2
RGLRU_BWD_F32_REL_L2 = 1e-4


def _rglru_bwd_inputs(gen, B, S, C, init, dstate, decay, ga_scale,
                      zero_share=0.0):
    x, ga, gi, la, h0 = _rglru_inputs(gen, B, S, C, init, decay)
    dh = _randn(gen, B, S, C)
    ds = torch.randn((B, C), generator=gen, device="cuda") if dstate \
        else None
    if zero_share:
        zero = torch.rand((B, S, C), generator=gen, device="cuda") < zero_share
        ga = ga.masked_fill(zero, 0.0)
    return x, ga * ga_scale, gi, la, dh, ds, h0


@pytest.mark.parametrize("case", RGLRU_BWD, ids=str)
def test_rglru_backward_kernel_matches_plain(case, gen):
    from repro_torch.kernels.rglru_scan_bwd import (
        rglru_bwd_cuda,
        rglru_bwd_plain,
    )

    x, ga, gi, la, dh, ds, h0 = _rglru_bwd_inputs(gen, *case)
    entering = rglru_cuda(x, ga, gi, la, initial_state=h0, entering=True)[2]
    got = rglru_bwd_cuda(x, ga, gi, la, dh, ds, entering=entering,
                         initial_state=h0)
    again = rglru_bwd_cuda(x, ga, gi, la, dh, ds, entering=entering,
                           initial_state=h0)
    want = rglru_bwd_plain(x.float(), ga, gi, la, dh, ds, initial_state=h0)
    torch.cuda.synchronize()
    assert (got[4] is None) == (h0 is None)
    for name, g, a, w in zip(("dx", "dga", "dgi", "dla", "dh0"), got, again,
                             want):
        if w is None:
            continue
        assert g.shape == w.shape and torch.isfinite(g).all(), name
        assert torch.equal(g, a), f"{name}: two launches differ"
        if not w.any():
            assert not g.any(), name
            continue
        limit = max(RGLRU_BWD_REL_L2, 2 * _rel_l2(w.to(g.dtype), w)) \
            if g.dtype == torch.bfloat16 else RGLRU_BWD_F32_REL_L2
        assert _rel_l2(g, w) <= limit, (name, _rel_l2(g, w), limit)


def test_rglru_backward_holds_every_cta_of_the_training_shape(gen):
    """The scan kernel's TMA instantiation (the training shape's) runs
    three CTAs an SM, so recurrentgemma-2b's 320 (B 4, 2560 channels in
    tiles of 32) are resident at once on an H100's 132 SMs."""
    from repro_torch.kernels import rglru_scan_bwd as rb

    blocks = rb.occupancy(tma=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert blocks >= 3, blocks
    assert blocks * sms >= 4 * 2560 // rb.TILE


def test_rglru_under_grad_on_the_card_matches_the_plain_backward(gen):
    """Under grad, ops.rglru on CUDA tensors goes through RGLRUScan: one
    forward and one backward launch, the gradients (x in bf16 within 3e-2
    relative L2 of the plain backward, the gates, log_a and the initial
    state in fp32 within 1e-4); without grad only the forward launches."""
    from repro_torch.kernels.rglru_scan_bwd import rglru_bwd_plain

    x, ga, gi, la, dh, ds, h0 = _rglru_bwd_inputs(gen, 2, 200, 96, True,
                                                  True, 1.0, 1.0)
    leaves = [t.clone().requires_grad_() for t in (x, ga, gi, la, h0)]
    ops.reset_launch_counts()
    h, state = ops.rglru(*leaves[:4], initial_state=leaves[4])
    torch.autograd.backward((h, state), (dh, ds))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["rglru_scan"] == 1 and counts["rglru_scan_bwd"] == 1
    want = rglru_bwd_plain(x.float(), ga, gi, la, dh, ds, initial_state=h0)
    assert [t.grad.dtype for t in leaves] == [torch.bfloat16] + \
        [torch.float32] * 4
    for t, w in zip(leaves, want):
        assert torch.isfinite(t.grad).all()
        assert _rel_l2(t.grad, w) <= (
            RGLRU_BWD_REL_L2 if t.grad.dtype == torch.bfloat16
            else RGLRU_BWD_F32_REL_L2)
    with torch.no_grad():
        ops.reset_launch_counts()
        ops.rglru(x, ga, gi, la)
        assert ops.launch_counts()["rglru_scan_bwd"] == 0


@pytest.mark.parametrize("arch,kernel", [("yi-6b", "flash_attention_bwd"),
                                         ("mamba2-2.7b", "ssd_scan_bwd")])
def test_train_step_through_the_kernels_matches_the_plain_route(arch, kernel,
                                                                gen):
    """Full-width yi-6b and mamba2-2.7b at 2 layers, B 2 x 256: one step's
    gradients through the kernels against the plain versions, each stacked
    leaf within max(5e-2, 2 x floor) relative L2 (floor: plain bf16 vs
    fp32)."""
    import dataclasses

    from repro_torch.configs.shapes import InputShape
    from repro_torch.data import pipeline as data
    from repro_torch.tree import leaves

    cfg = dataclasses.replace(get_arch(arch), n_layers=2)
    params = lm.init(cfg, seed=0, device="cuda", dtype=torch.float32,
                     stacked=True)
    ps = [p.requires_grad_() for p in leaves(params)]
    batch = data.batch_for_step(cfg, InputShape("t", 256, 2, "train"), 0,
                                device="cuda")

    def grads(backend, dtype):
        total, _ = lm.loss_fn(cfg, params, batch, backend=backend,
                              dtype=dtype)
        return torch.autograd.grad(total, ps)

    ops.reset_launch_counts()
    kernels = grads("kernel", torch.bfloat16)
    assert ops.launch_counts()[kernel] == 2
    plain = grads("ref", torch.bfloat16)
    truth = grads("ref", torch.float32)
    for k, p, t in zip(kernels, plain, truth):
        assert torch.isfinite(k).all()
        assert _rel_l2(k, p) <= max(5e-2, 2 * _rel_l2(p, t))


def test_recurrentgemma_train_step_through_the_kernels(gen):
    """Full-width recurrentgemma-2b at 3 layers (rec, rec, local), B 2 x
    256: one step's gradients through the kernels against the plain
    versions, each stacked leaf within max(5e-2, 2 x floor) relative L2
    (floor: plain bf16 vs fp32); two RG-LRU and one flash backward
    launch."""
    import dataclasses

    from repro_torch.configs.shapes import InputShape
    from repro_torch.data import pipeline as data
    from repro_torch.tree import leaves

    cfg = dataclasses.replace(get_arch("recurrentgemma-2b"), n_layers=3)
    params = lm.init(cfg, seed=0, device="cuda", dtype=torch.float32,
                     stacked=True)
    ps = [p.requires_grad_() for p in leaves(params)]
    batch = data.batch_for_step(cfg, InputShape("t", 256, 2, "train"), 0,
                                device="cuda")

    def grads(backend, dtype):
        total, _ = lm.loss_fn(cfg, params, batch, backend=backend,
                              dtype=dtype)
        return torch.autograd.grad(total, ps)

    ops.reset_launch_counts()
    kernels = grads("kernel", torch.bfloat16)
    counts = ops.launch_counts()
    assert counts["rglru_scan"] == counts["rglru_scan_bwd"] == 2
    assert counts["flash_attention"] == counts["flash_attention_bwd"] == 1
    plain = grads("ref", torch.bfloat16)
    truth = grads("ref", torch.float32)
    for k, p, t in zip(kernels, plain, truth):
        assert torch.isfinite(k).all()
        assert _rel_l2(k, p) <= max(5e-2, 2 * _rel_l2(p, t))


@pytest.mark.parametrize("arch", ["whisper-large-v3", "pixtral-12b"])
def test_prefixed_models_through_the_kernels_match_the_plain_route(arch,
                                                                   gen):
    """Full-width whisper-large-v3 (2 encoder and 2 decoder layers, B 2 x
    (64 tokens + 1536 frames)) and pixtral-12b (2 layers, B 2 x (1024
    patches + 64 tokens)) in bf16: prefill and two decode steps through
    the kernels against the plain route, relative L2 of each logits
    vector within max(5e-2, 2 x floor) (floor: plain bf16 vs plain
    fp32); whisper's cross attention through flash in the prefill and in
    each decode step."""
    import dataclasses

    cfg = get_arch(arch)
    enc = None if cfg.encoder is None else dataclasses.replace(
        cfg.encoder, n_layers=2)
    cfg = dataclasses.replace(cfg, n_layers=2, encoder=enc)
    params = lm.init(cfg, seed=0, device="cuda")
    n, prefix = 64, cfg.n_patches
    tokens = torch.randint(0, cfg.vocab_size, (2, n), generator=gen,
                           device="cuda")
    extra = {}
    if cfg.encoder is not None:
        extra["enc_frames"] = 0.02 * _randn(gen, 2, cfg.encoder.n_frames,
                                            cfg.d_model)
    if prefix:
        extra["patches"] = 0.02 * _randn(gen, 2, prefix, cfg.d_model)

    def run(backend, dtype=torch.bfloat16):
        logits, caches = lm.prefill(cfg, params, tokens, backend=backend,
                                    max_seq=prefix + n + 8, dtype=dtype,
                                    **extra)
        out = [logits.float()]
        lengths = torch.full((2,), prefix + n, dtype=torch.int32,
                             device="cuda")
        for tok in tokens[:, :2].T:
            logits, caches = lm.decode_step(cfg, params, tok, caches,
                                            lengths, backend=backend,
                                            dtype=dtype)
            out.append(logits.float())
            lengths = lengths + 1
        return out

    ops.reset_launch_counts()
    got = run("kernel")
    counts = ops.launch_counts()
    # encoder, self and cross layers in the prefill; cross at each step
    cross = 2 if cfg.encoder is not None else 0
    assert counts["flash_attention"] == cross + 2 + cross * (1 + 2)
    assert counts["decode_attention"] == 2 * 2
    plain, truth = run("ref"), run("ref", torch.float32)
    torch.cuda.synchronize()

    def rel(a, b):
        return max(float(((x - y).norm(dim=-1) / y.norm(dim=-1)).max())
                   for x, y in zip(a, b))

    assert all(torch.isfinite(g).all() for g in got)
    assert rel(got, plain) <= max(5e-2, 2 * rel(plain, truth))


def test_preemptive_training_example_survives_its_preemption(gen):
    from repro_torch.examples import preemptive_training

    ops.reset_launch_counts()
    out = preemptive_training.main(["--steps", "40"])
    cut = int(40 * 0.4)
    assert [r["step"] for r in out["seg1"]] == list(range(cut))
    assert [r["step"] for r in out["seg2"]] == list(range(cut, 40))
    assert all(torch.isfinite(torch.tensor(r["nll"]))
               for r in out["seg1"] + out["seg2"])
    counts = ops.launch_counts()
    assert counts["flash_attention"] == counts["flash_attention_bwd"] \
        == 10 * 40


# ------------------------------------------------------ reduced configs
# The kernels each mixer launches when a model serves (prefill, decode)
# and trains; MLA decodes with plain products, as the reference does.
MIXER_KERNELS = {
    "gqa": ("flash_attention", "decode_attention", "flash_attention_bwd"),
    "local": ("flash_attention", "decode_attention", "flash_attention_bwd"),
    "mla": ("flash_attention", "flash_attention_bwd"),
    "ssd": ("ssd_scan", "ssd_scan_bwd"),
    "rglru": ("rglru_scan", "rglru_scan_bwd"),
}


class _Routes:
    """Records the experts of every MoE routing call (``moe.route``), or,
    given another run's record, routes each call to the recorded experts
    with gates renormalised from this run's probabilities: a tie in the
    router that the kernels' roundings tip would otherwise swamp their
    own difference."""

    def __init__(self, monkeypatch, replay=None):
        from repro_torch.models import moe

        # the model's own route, under any earlier _Routes of the test
        real = getattr(moe.route, "__wrapped__", moe.route)
        self.picks = []

        def route(*args, **kwargs):
            probs, gate, idx = real(*args, **kwargs)
            if replay is not None:
                idx = replay[len(self.picks)]
                gate = probs.gather(-1, idx)
                gate = gate / torch.clamp(gate.sum(-1, keepdim=True),
                                          min=1e-9)
            self.picks.append(idx)
            return probs, gate, idx

        route.__wrapped__ = real
        monkeypatch.setattr(moe, "route", route)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_reduced_config_serves_and_trains_through_the_kernels(
        arch, gen, monkeypatch):
    """Every arch of the zoo at ``.reduced()`` (head dim 32; MLA's qk 48
    padded to 64 beside v 32) in bf16: prefill of 8 tokens (after
    pixtral's 8 patches; whisper with its 32 frames) and two decode steps,
    then one train step's gradients at B 2 x 16 tokens, through the
    kernels against the plain route, the logits and each stacked leaf
    within max(5e-2, 2 x floor) relative L2 (floor: plain bf16 vs fp32;
    in the MoE archs the plain runs take the kernel run's experts); every
    kernel of the arch's mixers launched, and no other."""
    from repro_torch.configs.shapes import InputShape
    from repro_torch.data import pipeline as data
    from repro_torch.tree import leaves

    cfg = get_arch(arch).reduced()
    mixers = {spec.mixer for stage in lm.build_plan(cfg)
              for spec in stage.unit}
    want = {k for m in mixers for k in MIXER_KERNELS[m]}
    params = lm.init(cfg, seed=0, device="cuda")
    prefix, n = cfg.n_patches, 8
    tokens = torch.randint(0, cfg.vocab_size, (2, n), generator=gen,
                           device="cuda")
    extra = {}
    if cfg.encoder is not None:
        extra["enc_frames"] = 0.02 * _randn(gen, 2, cfg.encoder.n_frames,
                                            cfg.d_model)
    if prefix:
        extra["patches"] = 0.02 * _randn(gen, 2, prefix, cfg.d_model)

    def serve(backend, dtype=torch.bfloat16):
        logits, caches = lm.prefill(cfg, params, tokens, backend=backend,
                                    max_seq=prefix + n + 8, dtype=dtype,
                                    **extra)
        out = [logits.float()]
        lengths = torch.full((2,), prefix + n, dtype=torch.int32,
                             device="cuda")
        for tok in tokens[:, :2].T:
            logits, caches = lm.decode_step(cfg, params, tok, caches,
                                            lengths, backend=backend,
                                            dtype=dtype)
            out.append(logits.float())
            lengths = lengths + 1
        return out

    def rel(a, b):
        return max(float(((x - y).norm(dim=-1) / y.norm(dim=-1)).max())
                   for x, y in zip(a, b))

    ops.reset_launch_counts()
    routes = _Routes(monkeypatch)
    got = serve("kernel")
    _Routes(monkeypatch, routes.picks)
    plain = serve("ref")
    _Routes(monkeypatch, routes.picks)
    truth = serve("ref", torch.float32)
    assert all(torch.isfinite(g).all() for g in got)
    assert rel(got, plain) <= max(5e-2, 2 * rel(plain, truth))

    tparams = lm.init(cfg, seed=0, device="cuda", dtype=torch.float32,
                      stacked=True)
    ps = [p.requires_grad_() for p in leaves(tparams)]
    batch = data.batch_for_step(cfg, InputShape("t", prefix + 16, 2,
                                                "train"), 0, device="cuda")

    def grads(backend, dtype):
        total, _ = lm.loss_fn(cfg, tparams, batch, backend=backend,
                              dtype=dtype)
        return torch.autograd.grad(total, ps)

    routes = _Routes(monkeypatch)
    kernels = grads("kernel", torch.bfloat16)
    counts = ops.launch_counts()
    assert {k for k, c in counts.items() if c > 0} == want, counts
    _Routes(monkeypatch, routes.picks)
    plain = grads("ref", torch.bfloat16)
    _Routes(monkeypatch, routes.picks)
    truth = grads("ref", torch.float32)
    for k, p, t in zip(kernels, plain, truth):
        assert torch.isfinite(k).all()
        assert _rel_l2(k, p) <= max(5e-2, 2 * _rel_l2(p, t))


def test_quickstart_runs_on_the_card(gen):
    from repro_torch.examples import quickstart

    ops.reset_launch_counts()
    run = quickstart.main([])
    assert len(run["nll"]) == 12 and run["predicted_s"] > 0
    counts = ops.launch_counts()
    assert counts["flash_attention"] == counts["flash_attention_bwd"] \
        == 12 * get_arch("yi-6b").reduced().n_layers


# ---------------------------------------------------------------- sharding
@pytest.mark.parametrize("lens", [[1, 300, 777, 1096], [0, 5, 0, 9]])
def test_decode_lse_matches_plain_and_leaves_out_bitwise(gen, lens):
    """The decode kernel's lse against its plain version (-inf exactly at
    length 0), and ``out`` bitwise the same with the lse and without."""
    q = _randn(gen, 4, 32, 128)
    kc, vc = _randn(gen, 4, 1096, 4, 128), _randn(gen, 4, 1096, 4, 128)
    length = torch.tensor(lens, dtype=torch.int32, device="cuda")
    out = decode_attention_cuda(q, kc, vc, length)
    got, lse = decode_attention_cuda(q, kc, vc, length, return_lse=True)
    _, want = decode_attention_plain(q.float(), kc.float(), vc.float(),
                                     length, return_lse=True)
    assert torch.equal(got, out)
    empty = (length == 0)[:, None].expand_as(lse)
    assert bool((torch.isneginf(lse) == empty).all())
    _close(lse[~empty], want[~empty])
    assert not bool(decode_counters(q.device).any())


@pytest.fixture
def one_rank_mesh():
    """A (1, 1) ("data", "model") mesh of one NCCL rank (a HashStore: no
    port opened)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_test_mesh

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    try:
        yield make_test_mesh((1, 1), device_type="cuda")
    finally:
        dist.destroy_process_group()


def test_a_dtensor_reaching_a_kernel_raises(gen, one_rank_mesh):
    from torch.distributed.tensor import Replicate, distribute_tensor

    q = distribute_tensor(_randn(gen, 1, 64, 2, 64), one_rank_mesh,
                          [Replicate(), Replicate()])
    with pytest.raises(TypeError, match="DTensor"):
        flash_attention_cuda(q, q, q)
    with pytest.raises(TypeError, match="local_map"):
        ops.flash_attention(q, q, q)


def _serve(cfg, params, prompt, mesh, steps_):
    """Prefill and two decode steps through build_step: the logits."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs.shapes import InputShape
    from repro_torch.sharding.specs import placements

    B, S = prompt.shape
    pre = steps_.build_step(cfg, InputShape("p", S + 8, B, "prefill"),
                            mesh=mesh).fn
    dec = steps_.build_step(cfg, InputShape("d", S + 8, B, "decode"),
                            mesh=mesh).fn
    batch = {"tokens": prompt}
    if mesh is not None:
        params = steps_.place(params, mesh)
        batch = steps_.place(batch, mesh,
                             steps_.batch_specs(cfg, batch, mesh))
    logits, caches = pre(params, batch)
    outs = [logits]
    n = torch.full((B,), S, dtype=torch.int32, device="cuda")
    tok = prompt[:, -1]
    for i in range(2):
        t, m = tok, n + i
        if mesh is not None:
            pl = placements(steps_.token_spec(B, mesh), mesh)
            t, m = distribute_tensor(t, mesh, pl), distribute_tensor(m, mesh,
                                                                     pl)
        logits, caches = dec(params, t, caches, m)
        outs.append(logits)
        tok = (logits.full_tensor() if mesh is not None else logits) \
            .argmax(-1)
    torch.cuda.synchronize()
    return [o.full_tensor() if mesh is not None else o for o in outs]


@pytest.mark.parametrize("arch", ["yi-6b", "mamba2-2.7b",
                                  "recurrentgemma-2b"])
def test_one_rank_sharded_serving_is_the_unsharded_bitwise(gen, arch,
                                                           one_rank_mesh):
    """Reduced configs on the (1, 1) mesh: the sharded prefill and decode
    steps run the kernels inside local_map (counts > 0) and give the
    unsharded steps' bits."""
    from repro_torch.launch import steps as steps_

    cfg = get_arch(arch).reduced()
    params = lm.init(cfg, seed=0, device="cuda", stacked=True)
    prompt = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen,
                           device="cuda")
    want = _serve(cfg, params, prompt, None, steps_)
    ops.reset_launch_counts()
    got = _serve(cfg, params, prompt, one_rank_mesh, steps_)
    counts = ops.launch_counts()
    mixers = {"yi-6b": ("flash_attention", "decode_attention"),
              "mamba2-2.7b": ("ssd_scan",),
              "recurrentgemma-2b": ("flash_attention", "decode_attention",
                                    "rglru_scan")}[arch]
    assert all(counts[k] > 0 for k in mixers), counts
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _two_rank_worker(rank: int, port: int, result) -> None:
    """One of two NCCL ranks: reduced yi-6b served on a (1, 2) mesh (the
    sequence of the prompt and of the cache over ``model``)."""
    import torch.distributed as dist

    from repro_torch.launch import steps as steps_
    from repro_torch.launch.mesh import make_test_mesh

    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=2,
                            device_id=torch.device("cuda", rank))
    try:
        cfg = get_arch("yi-6b").reduced()
        params = lm.init(cfg, seed=0, device="cuda", stacked=True)
        g = torch.Generator(device="cuda")
        g.manual_seed(0)
        prompt = torch.randint(0, cfg.vocab_size, (2, 16), generator=g,
                               device="cuda")
        got = _serve(cfg, params, prompt, make_test_mesh(
            (1, 2), device_type="cuda"), steps_)
        want = _serve(cfg, params, prompt, None, steps_)
        errs = [float(((a.float() - b.float()).norm() / b.float().norm()))
                for a, b in zip(got, want)]
        if rank == 0:
            result.put(errs)
    finally:
        dist.destroy_process_group()


def test_two_rank_sharded_serving_matches_unsharded():
    """Two NCCL ranks on two cards; skips on a machine with fewer."""
    import socket

    import torch.multiprocessing as mp

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    result = ctx.Queue()
    mp.start_processes(_two_rank_worker, args=(port, result), nprocs=2,
                       join=True, start_method="spawn")
    errs = result.get(timeout=60)
    # bf16 serving, slices combined by log-sum-exp in fp32: PERF.md's
    # model bound
    assert max(errs) <= 5e-2, errs
