"""The SSD scan's backward in the port, on the CPU.

The same numpy inputs (drawn from ``default_rng``) go through the port's
plain backward (``ssd_scan_bwd.ssd_bwd_plain``), through ``ops.ssd`` under
autograd (``ops.SSDScan``, which takes the plain versions for CPU
tensors) and through ``jax.vjp`` of the JAX package's ``ops.ssd``: its XLA
chunked scan and its sequential oracle (``backend="ref"``).  In float32
every gradient (x, dt, A, B, C, the initial state) agrees within 1e-4
relative L2: the same formula summed in another order.  The CUDA kernel
itself runs only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``); here its shared-memory, schedule and tiling mirrors
are held to the source, and the plain formula at the kernels' chunk and
rounding to the float32 formula.
"""

import itertools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch import intra_op_threads
from repro_torch.kernels import _build, ops
from repro_torch.kernels import ssd_scan_bwd as sb
from repro_torch.kernels.ssd_scan import (
    MAX_SMEM,
    smem_bytes as fwd_smem_bytes,
    ssd_plain,
    state_tiles_per_warp,
)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The module's CPU work on one intra-op thread: its small products
    would wake every thread, which under the suite's parallel workers
    makes them many times slower (the rule of ``README.md``'s "Tests on
    the CPU")."""
    with intra_op_threads(1):
        yield


F32_REL_L2 = 1e-4
GRADS = ("dx", "ddt", "dA", "dB", "dC", "dh0")

CASES = [
    # (B, S, H, P, G, N, chunk, initial_state, final-state cotangent, decay)
    (1, 16, 2, 4, 1, 8, 8, False, False, 1.0),      # G 1, chunk < S
    (2, 32, 4, 8, 2, 16, 8, True, True, 1.0),       # G 2, both states
    (1, 24, 2, 8, 1, 4, 12, True, False, 1.0),      # ragged N
    (2, 16, 4, 8, 2, 16, 32, True, True, 1.0),      # chunk >= S
    (2, 48, 6, 8, 3, 8, 16, False, True, 1.0),      # G 3, cotangent only
    (2, 64, 4, 8, 1, 16, 16, True, True, 300.0),    # strong decay
]


def _inputs(case, seed):
    """numpy float32 x, dt, A, B, C, dy, the final state's cotangent (zeros
    when the case has none) and the initial state (None without)."""
    B, S, H, P, G, N, _, init, dstate, decay = case
    rng = np.random.default_rng(seed)
    f32 = np.float32
    x = rng.standard_normal((B, S, H, P), dtype=f32) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H), dtype=f32)))
    A = (-np.exp(rng.standard_normal((H,), dtype=f32)) * decay).astype(f32)
    Bm = rng.standard_normal((B, S, G, N), dtype=f32) * 0.3
    Cm = rng.standard_normal((B, S, G, N), dtype=f32) * 0.3
    dy = rng.standard_normal((B, S, H, P), dtype=f32)
    ds = rng.standard_normal((B, H, P, N), dtype=f32) * 0.5
    if not dstate:
        ds = np.zeros_like(ds)
    h0 = rng.standard_normal((B, H, P, N), dtype=f32) * 0.2 if init else None
    return x, dt, A, Bm, Cm, dy, ds, h0


def _jax_grads(case, arrays, backend):
    """jax.vjp of the JAX package's ops.ssd: the gradients of x, dt, A, B,
    C and (if any) the initial state, as numpy arrays."""
    chunk = case[6]
    x, dt, A, Bm, Cm, dy, ds, h0 = arrays
    primals = [jnp.asarray(a) for a in (x, dt, A, Bm, Cm)]
    if h0 is not None:
        primals.append(jnp.asarray(h0))

    def f(*p):
        return jops.ssd(*p[:5], chunk=chunk,
                        initial_state=p[5] if h0 is not None else None,
                        backend=backend)

    _, vjp = jax.vjp(f, *primals)
    return [np.asarray(g) for g in vjp((jnp.asarray(dy), jnp.asarray(ds)))]


def _np32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def _rel_l2(got, want) -> float:
    got, want = _np32(got), _np32(want)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def _plain(case, arrays, dtype=torch.float32):
    x, dt, A, Bm, Cm, dy, ds, h0 = (None if a is None else torch.from_numpy(a)
                                    for a in arrays)
    return sb.ssd_bwd_plain(x, dt, A, Bm, Cm, dy, ds, chunk=case[6],
                            initial_state=h0, dtype=dtype)


@pytest.mark.parametrize("backend", ["ref", "xla"])
@pytest.mark.parametrize("case", CASES, ids=str)
def test_plain_backward_matches_jax_vjp(case, backend):
    """Every gradient of the plain backward against jax.vjp of the
    reference's ssd.  One exception, under strong decay: dA from the XLA
    scan's autodiff, which loses its digits there (see the next test), is
    held to the sequential oracle's only."""
    arrays = _inputs(case, 300 + CASES.index(case))
    got = _plain(case, arrays)
    want = _jax_grads(case, arrays, backend)
    assert (got[5] is None) == (arrays[7] is None)
    strong = case[-1] > 1.0
    for name, g, w in zip(GRADS, got, want):
        if name == "dA" and strong and backend == "xla":
            continue
        assert g.shape == w.shape and g.dtype == torch.float32, name
        assert _rel_l2(g, w) <= F32_REL_L2, (name, _rel_l2(g, w))


def test_strong_decay_da_follows_the_sequential_oracle():
    """Under strong decay (A dt ~ -300) dA is a sum of terms that nearly
    cancel.  The XLA scan's autodiff cancels the diagonal and the chunk
    total's terms after the fact and is left off the sequential oracle's
    float32 gradient by ~1.2e-3 relative L2; the port's backward never
    forms the cancelling pairs and stays within 1e-4 of it (~8e-6)."""
    case = CASES[-1]
    arrays = _inputs(case, 300 + CASES.index(case))
    port = _plain(case, arrays)[2]
    oracle = _jax_grads(case, arrays, "ref")[2]
    xla = _jax_grads(case, arrays, "xla")[2]
    assert _rel_l2(port, oracle) <= F32_REL_L2
    assert _rel_l2(xla, oracle) > 5 * F32_REL_L2


@pytest.mark.parametrize("case", CASES, ids=str)
def test_ops_ssd_under_autograd_matches_jax_vjp(case):
    """``ops.ssd`` under grad goes through ``SSDScan`` and its plain
    backward: autograd's gradients of every input against jax.vjp of the
    reference's XLA scan (its strong-decay dA against the oracle)."""
    arrays = _inputs(case, 400 + CASES.index(case))
    x, dt, A, Bm, Cm, dy, ds, h0 = arrays
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, dt, A, Bm, Cm)]
    init = torch.from_numpy(h0).requires_grad_() if h0 is not None else None
    y, state = ops.ssd(*leaves, chunk=case[6], initial_state=init)
    assert type(y.grad_fn).__name__ == "SSDScanBackward"
    loss = (y * torch.from_numpy(dy)).sum() \
        + (state * torch.from_numpy(ds)).sum()
    loss.backward()
    got = [t.grad for t in leaves] + ([init.grad] if init is not None else [])
    want = _jax_grads(case, arrays, "xla")
    oracle = _jax_grads(case, arrays, "ref")
    for name, g, w, o in zip(GRADS, got, want, oracle):
        if name == "dA" and case[-1] > 1.0:
            w = o
        assert _rel_l2(g, w) <= F32_REL_L2, (name, _rel_l2(g, w))


def test_ops_ssd_without_grad_is_the_serving_call():
    """Without an input that requires grad, ops.ssd returns the forward's
    own tensors: no autograd node, the same values as ssd_plain."""
    case = CASES[1]
    x, dt, A, Bm, Cm, _, _, h0 = (None if a is None else torch.from_numpy(a)
                                  for a in _inputs(case, 7))
    y, state = ops.ssd(x, dt, A, Bm, Cm, chunk=case[6], initial_state=h0)
    want_y, want_state = ssd_plain(x, dt, A, Bm, Cm, chunk=case[6],
                                   initial_state=h0)
    assert y.grad_fn is None and state.grad_fn is None
    assert torch.equal(y, want_y) and torch.equal(state, want_state)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_plain_backward_matches_autograd_of_the_plain_forward(case):
    """The backward's formula against torch.autograd of the plain forward
    (ssd_plain, float32) on the same inputs, in one framework."""
    arrays = _inputs(case, 500 + CASES.index(case))
    x, dt, A, Bm, Cm, dy, ds, h0 = arrays
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, dt, A, Bm, Cm)]
    if h0 is not None:
        leaves.append(torch.from_numpy(h0).requires_grad_())
    y, state = ssd_plain(*leaves[:5], chunk=case[6],
                         initial_state=leaves[5] if h0 is not None else None)
    want = torch.autograd.grad((y, state), leaves,
                               (torch.from_numpy(dy), torch.from_numpy(ds)))
    got = _plain(case, arrays)
    for name, g, w in zip(GRADS, got, want):
        if name == "dA" and case[-1] > 1.0:
            continue    # autograd of the chunked forward cancels as XLA's does
        assert _rel_l2(g, w) <= F32_REL_L2, (name, _rel_l2(g, w))


def test_missing_cotangent_counts_as_zeros():
    case = CASES[1]
    x, dt, A, Bm, Cm, dy, _, h0 = (None if a is None else torch.from_numpy(a)
                                   for a in _inputs(case, 11))
    none = sb.ssd_bwd_plain(x, dt, A, Bm, Cm, dy, None, chunk=case[6],
                            initial_state=h0)
    zeros = sb.ssd_bwd_plain(x, dt, A, Bm, Cm, dy, torch.zeros_like(h0),
                             chunk=case[6], initial_state=h0)
    assert all(torch.equal(a, b) for a, b in zip(none, zeros))


def test_bf16_plain_backward_keeps_dtypes_and_stays_near_float32():
    """The floor of the card's check: the plain backward with bf16 product
    operands, on bf16 x, B, C and dy, returns the inputs' dtypes and stays
    within the card's 3e-2 of the float32 formula at a small size."""
    case = (2, 64, 4, 16, 2, 32, 32, True, True, 1.0)
    x, dt, A, Bm, Cm, dy, ds, h0 = (None if a is None else torch.from_numpy(a)
                                    for a in _inputs(case, 13))
    bf = torch.bfloat16
    args = (x.to(bf), dt, A, Bm.to(bf), Cm.to(bf), dy.to(bf), ds)
    kw = dict(chunk=case[6], initial_state=h0)
    truth = sb.ssd_bwd_plain(*args, **kw)
    floor = sb.ssd_bwd_plain(*args, dtype=bf, **kw)
    assert [t.dtype for t in floor] == [bf, torch.float32, torch.float32, bf,
                                        bf, torch.float32]
    for name, f, t in zip(GRADS, floor, truth):
        assert 0 < _rel_l2(f, t) <= 3e-2, name


@pytest.mark.parametrize("chunk", [64, 256])
def test_sub_chunks_give_the_same_function(chunk):
    """The kernels run a chunk over 128 as equal sub-chunks: in float32 the
    formula at chunk 256 and at its 128-row sub-chunks agree within 1e-4,
    and the bf16 floor, which follows the kernels' chunk, stays within the
    card's 3e-2 of the float32 formula at the chunk asked for."""
    case = (2, 512, 4, 16, 2, 32, chunk, True, True, 1.0)
    x, dt, A, Bm, Cm, dy, ds, h0 = (None if a is None else torch.from_numpy(a)
                                    for a in _inputs(case, 17))
    kw = dict(initial_state=h0)
    whole = sb.ssd_bwd_plain(x, dt, A, Bm, Cm, dy, ds, chunk=chunk, **kw)
    parts = sb.ssd_bwd_plain(x, dt, A, Bm, Cm, dy, ds,
                             chunk=sb.kernel_chunk(chunk, 16, 32), **kw)
    for name, w, p_ in zip(GRADS, whole, parts):
        assert _rel_l2(p_, w) <= F32_REL_L2, (name, _rel_l2(p_, w))
    bf = torch.bfloat16
    args = (x.to(bf), dt, A, Bm.to(bf), Cm.to(bf), dy.to(bf), ds)
    truth = sb.ssd_bwd_plain(*args, chunk=chunk, **kw)
    floor = sb.ssd_bwd_plain(*args, chunk=chunk, dtype=bf, **kw)
    for name, f, t in zip(GRADS, floor, truth):
        assert 0 < _rel_l2(f, t) <= 3e-2, name


# ------------------------------------------------------------ the mirrors
SRC = (_build.CSRC / "ssd_scan_bwd.cu").read_text()


def _const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC)[1])


def _layout(struct: str, Q: int, P: int, N: int, member: str = "bytes"):
    """A member (by default ``bytes``) of a layout struct of the source, by
    evaluating its member initializers in order (C's integer division as
    Python's floor division)."""
    body = re.search(rf"struct {struct} \{{(.*?)\n\}};", SRC, re.S)[1]
    inits = re.search(r"\)\s*:\s*(.*?)\{\}", body, re.S)[1]
    env = {"Q": Q, "P": P, "N": N, "PAD": _const("PAD"),
           "WARPS": _const("THREADS") // 32, "STAGES": _const("STAGES"),
           "round16": lambda v: (v + 15) // 16 * 16,
           "round64": lambda v: (v + 63) // 64 * 64,
           "round1024": lambda v: (v + 1023) // 1024 * 1024}
    for name, expr in re.findall(r"(\w+)\(((?:[^()]|\([^()]*\))*)\)", inits):
        env[name] = int(eval(expr.replace(" / ", " // "), {}, env))
    return env[member]


SHAPES = [(128, 64, 128), (64, 32, 64), (256, 32, 32), (48, 24, 40),
          (16, 16, 16), (200, 64, 64), (40, 21, 35), (128, 128, 128)]


def test_constants_mirror_the_source():
    assert (_const("THREADS") // 32, _const("MAX_Q"), _const("MAX_P"),
            _const("MAX_N"), _const("PAD"), _const("STAGES"),
            _const("MAX_SMEM")) == \
        (sb._WARPS, sb._MAX_Q, sb._MAX_P, sb._MAX_N, sb._PAD, sb._STAGES,
         MAX_SMEM)
    # no atomic operation: two launches give the same bits
    assert not re.search(r"\batomic[A-Z]\w*\(|\batom\.|\bred\.", SRC)
    # one fp32 dB / dC partial per head slice, summed in slice order
    assert "[B, S, G x slices, N]" in SRC
    assert "for (int j = 0; j < a.n_sl; ++j) sum += p[(long long)j * a.N];" \
        in SRC


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_smem_bytes_mirror_the_source_layouts(shape):
    walk, chunk = sb.smem_bytes(*shape)
    assert walk == _layout("WalkLayout", *shape)
    assert chunk == _layout("ChunkLayout", *shape)


def test_mamba2_training_shape_fits_the_card():
    """The two-stage ring fits at the training shape and at every padded
    chunk, P and N of 64 or 128 but one: a chunk of 128 with P and N of
    128 does not fit, and the kernels run it as two of 64 (the source's
    static_assert names the same three largest shapes).  Every chunk the
    wrapper takes runs at a sub-chunk that fits."""
    walk, chunk = sb.smem_bytes(128, 64, 128)
    assert (walk, chunk) == (108544, 230464)
    assert max(walk, chunk) <= MAX_SMEM
    fits = {s: max(sb.smem_bytes(*s)) <= MAX_SMEM
            for s in itertools.product((64, 128), repeat=3)}
    assert [s for s, ok in fits.items() if not ok] == [(128, 128, 128)]
    for s in ((128, 64, 128), (128, 128, 64), (64, 128, 128)):
        assert f"ChunkLayout{s}.bytes <= MAX_SMEM".replace(" ", "") in \
            SRC.replace(" ", "")
    assert sb.kernel_chunk(128, 128, 128) == 64
    for Q in (16, 48, 64, 100, 128, 200, 256):
        for P in (8, 21, 64, 128):
            for N in (8, 35, 64, 128):
                k = sb.kernel_chunk(Q, P, N)
                assert Q % k == 0 and max(sb.smem_bytes(k, P, N)) <= MAX_SMEM
    # the forward takes the same shape (the autograd function runs both)
    assert fwd_smem_bytes(128, 64, 128) <= MAX_SMEM


def test_walks_tile_their_state_as_the_forward_does():
    """The walks carry [P, N] in registers with the forward's Tiling, so
    ``state_tiles_per_warp`` mirrors both; at most MAX_ST tiles a warp for
    every P and N the backward takes."""
    fwd = (_build.CSRC / "ssd_scan.cu").read_text()

    def ctor(src):
        return re.search(r"constexpr Tiling\(int Pp, int Np\).*?\n    \}",
                         src, re.S)[0]

    assert ctor(SRC) == ctor(fwd)
    assert all(state_tiles_per_warp(P, N) <= _const("MAX_ST")
               for P in range(1, sb._MAX_P + 1, 7)
               for N in range(1, sb._MAX_N + 1, 5))
    assert state_tiles_per_warp(64, 128) == 8


@pytest.mark.parametrize("H,G,R,Q,P,N", [
    (80, 1, 20, 128, 64, 128),  # mamba2's training shape: four slices of 20
    (12, 2, 4, 128, 64, 128),   # 6 heads a group in slices of 4 and 2
    (12, 2, 8, 128, 64, 64),    # one slice of 6: fewer heads than R
    (12, 3, 3, 64, 32, 64),     # a chunk of one 64-row tile
    (7, 1, 3, 48, 24, 40),      # 3 + 3 + 1, a ragged chunk
    (8, 8, 2, 100, 64, 64),     # one head a group
    (6, 2, 1, 16, 32, 32),      # a head a CTA
    (5, 1, 5, 64, 128, 128),    # the group in one CTA; columns split
])
def test_chunk_schedule_takes_each_head_and_row_tile_once(H, G, R, Q, P, N):
    """Every (head, 64-row tile, dB / dC column) of a chunk is taken by
    exactly one warpgroup of one CTA, a CTA's heads lie in one group, and
    a CTA takes at most R of them."""
    sched = sb.chunk_schedule(H, G, R, Q, P, N)
    T = -(-Q // 64)
    assert len(sched) == G * -(-(H // G) // R)
    taken = sorted((h, t, n) for cta in sched for wg in cta
                   for h, t, lo, hi in wg for n in range(lo, min(hi, N)))
    assert taken == [(h, t, n) for h in range(H) for t in range(T)
                     for n in range(N)]
    for cta in sched:
        heads = sorted(dict.fromkeys(h for wg in cta for h, *_ in wg))
        assert 0 < len(heads) <= R
        assert heads[0] // (H // G) == heads[-1] // (H // G)
    assert "return make_int2(g * rep + sl * R, min(R, rep - sl * R));" in SRC
    assert "if (!SPLIT && wg >= T) return;" in SRC
    assert "const int r0 = SPLIT ? 0 : 64 * wg;" in SRC
    assert "const int n0 = SPLIT ? 64 * wg : 0;" in SRC
    assert "constexpr bool SPLIT = TP == 2 && TN == 2;" in SRC


def test_plan_fills_the_card_at_the_training_shape():
    """mamba2-2.7b's training shape (B 4, 8 chunks of 128, 80 heads, G 1):
    R 20, four slices a chunk, 128 CTAs in one wave on 132 SMs; the
    partials it writes are 1/20 of per-head ones."""
    R = sb.plan(4, 8, 80, 1, 132)
    assert R == 20
    assert 4 * 8 * 1 * -(-80 // R) == 128
    assert sb.plan(2, 2, 12, 2, 132) == 1       # few CTAs: one head each
    assert sb.plan(1, 1, 5, 1, 132) == 1


@pytest.mark.parametrize("Q,P,N,want", [
    (16, 64, 128, 16), (128, 64, 128, 128), (200, 64, 64, 100),
    (256, 32, 32, 128), (144, 64, 128, 72), (8, 64, 128, 8),
    (128, 128, 128, 64), (256, 128, 128, 64)])
def test_kernel_chunk_divides_the_chunk(Q, P, N, want):
    assert sb.kernel_chunk(Q, P, N) == want
    assert Q % want == 0 and want <= sb._MAX_Q
    assert max(sb.smem_bytes(want, P, N)) <= MAX_SMEM


@pytest.mark.parametrize("Q,P,N", [
    (131, 64, 128),     # prime: sub-chunks of one row
    (169, 64, 64),      # 13 x 13
    (127, 128, 128),    # too big for one chunk at P = N = 128, and prime
])
def test_kernel_chunk_refuses_sub_chunks_under_16_rows(Q, P, N):
    """A chunk whose only split that fits has sub-chunks under 16 rows is
    refused (each would be padded to 64 rows), not run at many times the
    work; the wrapper and the bf16 floor both go through kernel_chunk."""
    with pytest.raises(ValueError, match="at least 16 rows"):
        sb.kernel_chunk(Q, P, N)


def test_flop_counts_at_the_training_shape():
    """mamba2's training shape, 8 chunks of 128: the gradients need Z once,
    so two triangles over P per head, and the three over N once per
    group; the design issues per head the walks' two state products, four
    state products and four triangles by 64 x 64 blocks (three a chunk) in
    the chunk pass, and C·Bᵀ once per CTA of 20 heads."""
    function, design = sb.flops(4, 1024, 80, 64, 1, 128, 128, 132)
    state, pairs = 128 * 64 * 128, 128 * 129 // 2
    assert function == 2.0 * 4 * 8 * (80 * (5 * state + 2 * pairs * 64)
                                      + 3 * pairs * 128)
    blocks = 3 * 64 * 64
    assert design == 2.0 * (4 * 80 * 8 * (6 * state + blocks * 2 * (64 + 128))
                            + 128 * blocks * 128)
    assert (round(function / 1e9, 2), round(design / 1e9, 2)) == \
        (32.46, 56.77)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_the_gradients_need_no_more_products_than_the_design(shape):
    Q, P, N = shape
    counts = [sb.flops(2, 2 * Q, 8, P, G, N, Q, 132) for G in (1, 2, 8)]
    assert all(0 < function <= design for function, design in counts)
    # the N triangles are shared by a group's heads; the design forms C Bᵀ
    # once per CTA, and more groups make more CTAs
    assert counts[0][0] < counts[1][0] < counts[2][0]
    assert counts[0][1] <= counts[1][1] <= counts[2][1]


@pytest.mark.parametrize("Q", [16, 40, 64, 128, 200, 256])
def test_warp_cumsum_sums_in_the_kernels_order(Q):
    """``_warp_cumsum`` gives the bits of ``chunk_cumsum``'s shuffle scan,
    here replayed lane by lane in float32, and is a cumsum."""
    rng = np.random.default_rng(Q)
    v = (rng.standard_normal((1, 1, Q, 2), dtype=np.float32) * 100.0)
    got = sb._warp_cumsum(torch.from_numpy(v)).numpy()
    lanes = np.zeros((-(-Q // 32) * 32, 2), dtype=np.float32)
    lanes[:Q] = v[0, 0]
    want = np.empty_like(lanes)
    total = np.zeros(2, dtype=np.float32)
    for i in range(0, len(lanes), 32):
        cum = lanes[i:i + 32].copy()
        for o in (1, 2, 4, 8, 16):
            prev = cum.copy()
            for lane in range(o, 32):
                cum[lane] = prev[lane] + prev[lane - o]
        want[i:i + 32] = cum + total
        total = total + cum[31]
    assert np.array_equal(got[0, 0], want[:Q])
    np.testing.assert_allclose(got, np.cumsum(v, 2, dtype=np.float64),
                               rtol=1e-4, atol=1e-3)
    assert "cum[i] = q < Qp ? dts[q] * a2 : 0.f;" in SRC
