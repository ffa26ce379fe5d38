"""The flash backward kernel's design, on the CPU.

The CUDA kernel (``csrc/flash_attention_bwd.cu``) runs only on the card;
its wrapper module mirrors in Python what each CTA does
(:func:`dkdv_steps`, :func:`dq_tiles`) and how much shared memory it takes
(:func:`smem_bytes`).  These tests hold the mirrors to the source's
constants, the schedule to the mask (every visible (query, key, head) pair
exactly once in each kernel, no masked pair in a tile treated as
interior), and an emulation of the kernel's tiled arithmetic (its tile
order, per-warpgroup partials summed at the end, P and dS rounded to bf16,
the mask applied only on edge tiles) to the plain formula within the
bound the card is held to.  The card itself holds the kernel to the plain
formula (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention_bwd as fb
from repro_torch.kernels.flash_attention import flash_attention_plain

LOG2E = 1.4426950408889634
SMEM_LIMIT = 232_448           # the H100's dynamic shared memory per block
SMS = 132                      # the H100 SXM's SMs
BWD_REL_L2 = 2e-2              # the card's bound: max(2e-2, 2 x floor)

SCHEDULES = [
    # (Sq, Sk, mask_kind, window, q_offset)
    (200, 200, "causal", 0, 0),
    (130, 200, "causal", 0, 70),        # ragged, Sq != Sk, q_offset
    (150, 300, "window", 70, 150),      # window with q_offset
    (100, 60, "window", 40, 30),        # rows 70.. see no key
    (77, 190, "none", 0, 0),            # ragged Sq and Sk
    (64, 128, "causal", 0, 0),          # whole tiles only
    (8, 8, "window", 2, 20),            # no key in sight
    # Tile bounds exactly on a mask edge: n0 - q_offset = 63 (mod 64), and
    # a window whose first visible key ends a tile (q_offset - window = 62).
    (200, 200, "causal", 0, 1),
    (150, 300, "window", 40, 102),
]


def _visible(Sq, Sk, kind, window, off):
    q = np.arange(Sq)[:, None] + off
    k = np.arange(Sk)[None, :]
    if kind == "none":
        return np.ones((Sq, Sk), bool)
    ok = k <= q
    if kind == "window":
        ok &= k > q - window
    return ok


def test_tiles_and_ring_mirror_the_kernel_source():
    src = (_build.CSRC / "flash_attention_bwd.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    assert (const("BN"), const("BM"), const("Q_BM"), const("STAGES")) == \
        (fb.BN, fb.BM, fb.Q_BM, fb.STAGES)
    assert fb.Q_BM == 2 * fb.BM          # one 64-row block per warpgroup
    # no atomic operation: two launches give the same bits
    assert not re.search(r"\batomic[A-Z]\w*\(|\batom\.|\bred\.", src)


def test_wide_ring_mirrors_the_kernel_source():
    """The wide kernels' ring depths, hand-off buffers and the pairs they
    take equal the source's: the C entry launches the wide design at
    exactly ``WIDE_PAIRS`` and the split design at the other pairs of
    ``HEAD_DIMS``."""
    src = (_build.CSRC / "flash_attention_bwd.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    names = ("WKV_STAGES", "HANDOFF", "WQ_K_STAGES", "WQ_V_STAGES")
    assert [const(n) for n in names] == [getattr(fb, n) for n in names]
    # P^T goes through HANDOFF buffers indexed by the step, apart from the
    # ring's stages; the dQ warpgroups hand nothing over
    assert src.count("Ps + hb * (") == 1
    assert "constexpr int KW = BN / 2;" in src
    entry = src[src.index('extern "C" int flash_attention_bwd('):]
    entry = entry[:entry.index("\n}\n")]

    def pairs(pattern, text=entry):
        return sorted((int(d), int(dv)) for d, dv in re.findall(pattern,
                                                               text))

    # the entry's named set of wide pairs, each launched by the wide
    # design; every other pair it takes by the split design
    named = re.search(r"const bool wide = ([^;]+);", entry)[1]
    assert pairs(r"D == (\d+) && Dv == (\d+)", named) == \
        sorted(fb.WIDE_PAIRS)
    assert pairs(r"launch_wide<(\d+), (\d+)>") == sorted(fb.WIDE_PAIRS)
    assert pairs(r"\blaunch<(\d+), (\d+)>") == \
        sorted(set(fb.HEAD_DIMS) - set(fb.WIDE_PAIRS))


def test_one_slice_stores_its_gradients_without_parts():
    """At one slice (G 1: MLA's heads) the host launches the wide dK/dV
    kernel's ONE instantiation, which stores bf16 dK and dV by TMA with
    dK scaled as the reduction scales it, and skips the fp32 parts and
    the reduction; more slices write parts that the reduction sums."""
    src = (_build.CSRC / "flash_attention_bwd.cu").read_text()
    host = src[src.index("cudaError_t launch_wide("):]
    host = host[:host.index("\n}\n")]
    assert "splits == 1 ? flash_bwd_dkdv_wide_kernel<D, DV, true>" in host
    assert "if (V_SUM && splits > 1) {" in host
    kernel = src[src.index("flash_bwd_dkdv_wide_kernel(const"):]
    one = kernel[kernel.index("if constexpr (ONE) {"):]
    one = one[:one.index("return;")]
    assert "acc[j] *= scale;" in one and "tma_store_4d(" in one
    assert "part" not in one
    reduce = src[src.index("flash_bwd_dkdv_reduce_kernel(const"):]
    assert "const float f = which ? 1.f : scale;" in reduce


@pytest.mark.parametrize("kernel", ["flash_bwd_dkdv_wide_kernel",
                                    "flash_bwd_dq_wide_kernel"])
def test_wide_loops_have_no_cta_wide_barrier(kernel):
    """The wide kernels' loops synchronise their warpgroups by mbarriers
    only: no __syncthreads or named barrier between the loop's first ring
    wait and its end."""
    src = (_build.CSRC / "flash_attention_bwd.cu").read_text()
    body = src[src.index(f"{kernel}(const __grid_constant__"):]
    loop = body[re.search(r"for \(int i = 0; i < n_(steps|tiles); \+\+i\) \{",
                          body).start():]
    loop = loop[:re.search(r"wgmma_wait<0>\(\);\n +fence_regs<", loop).start()]
    assert "mbar_wait(" in loop and "wgmma_wait<" in loop
    for sync in ("__syncthreads", "named_barrier_sync", "bar.sync"):
        assert sync not in loop, sync


def test_wide_smem_mirror_matches_the_source_layouts():
    """smem_bytes at each wide pair is the sum of the sections the
    source's KvWideLayout and QWideLayout lay out, read from their
    initializers, and fits the card."""
    src = (_build.CSRC / "flash_attention_bwd.cu").read_text()

    def layout(name, D, Dv):
        body = src[src.index(f"struct {name} {{"):]
        body = body[:body.index("};")]
        vals = {"BN": fb.BN, "BM": fb.BM, "BOX": 64, "D": D, "DV": Dv,
                "WKV_STAGES": fb.WKV_STAGES, "HANDOFF": fb.HANDOFF,
                "WQ_K_STAGES": fb.WQ_K_STAGES, "WQ_V_STAGES": fb.WQ_V_STAGES}
        for key, expr in re.findall(
                r"static constexpr (?:uint32_t|int) (\w+) = ([^;]+);", body):
            vals[key] = eval(expr.replace("\n", " "), {}, vals)
        return vals["bytes"]

    for D, Dv in fb.WIDE_PAIRS:
        got = (layout("KvWideLayout", D, Dv), layout("QWideLayout", D, Dv))
        assert got == fb.smem_bytes(D, Dv)
        assert max(got) <= SMEM_LIMIT
        # the source asserts the fit of each wide pair it instantiates
        for name in ("KvWideLayout", "QWideLayout"):
            assert f"{name}<{D}, {Dv}>::bytes <= 232448" in src
    # each dQ warpgroup's keys start a whole number of swizzle atoms (8
    # rows) into a K or V box, and form whole k16 slices of dQ's product
    assert (fb.BN // 2) % 16 == 0


@pytest.mark.parametrize("dims", sorted(set(fb.HEAD_DIMS)
                                        - set(fb.WIDE_PAIRS)), ids=str)
def test_split_smem_mirror_matches_the_source_layouts(dims):
    """smem_bytes at each split pair is the sum of the sections the
    source's KvLayout and QLayout lay out, read from their initializers,
    at the pair's tile widths (the reduced configs' (32, 32) and (64, 32)
    run on (64, 64) tiles); the dK/dV epilogue's exchange fits the ring,
    as the source asserts."""
    src = (_build.CSRC / "flash_attention_bwd.cu").read_text()
    D, Dv = fb.tile_dims(*dims)

    def layout(name):
        body = src[src.index(f"struct {name} {{"):]
        body = body[:body.index("};")]
        vals = {"BN": fb.BN, "BM": fb.BM, "Q_BM": fb.Q_BM,
                "STAGES": fb.STAGES, "D": D, "DV": Dv}
        for key, expr in re.findall(
                r"static constexpr (?:uint32_t|int) (\w+) = ([^;]+);", body):
            vals[key] = eval(expr.replace("\n", " "), {}, vals)
        return vals

    kv, dq = layout("KvLayout"), layout("QLayout")
    assert (kv["bytes"], dq["bytes"]) == fb.smem_bytes(*dims)
    assert (D // 2 + Dv // 2) * 128 * 4 <= \
        fb.STAGES * (kv["q_bytes"] + kv["do_bytes"])


@pytest.mark.parametrize("ring", ["K", "V"])
@pytest.mark.parametrize("n_tiles", range(0, 9))
def test_wide_dq_rings_load_two_tiles_ahead(n_tiles, ring):
    """The wide dQ kernel's K and V rings: tile i on stage i % stages.
    The first `stages` tiles load at the start; at step i (after its dP
    and the previous tile's dQ product are done) one thread refills V's
    stage of tile i with tile i + WQ_V_STAGES and K's stage of tile i - 1
    with tile i - 1 + WQ_K_STAGES, once both warpgroups released them (V
    after dP of that tile, K after its dQ product, at the next step).  So
    every refilled tile is issued two steps before its own, on the stage
    its last occupant left."""
    S = fb.WQ_K_STAGES if ring == "K" else fb.WQ_V_STAGES
    freed = (lambda t: t + 1) if ring == "K" else (lambda t: t)
    loads = {i: -1 for i in range(min(n_tiles, S))}
    for step in range(n_tiles):               # the kernel's refill rule
        j = step - 1 + S if ring == "K" else step + S
        if (ring == "V" or step >= 1) and j < n_tiles:
            assert j not in loads
            loads[j] = step
    assert sorted(loads) == list(range(n_tiles))
    for j, at in loads.items():
        if at < 0:
            continue
        assert j % S == (j - S) % S and freed(j - S) <= at
        assert j - at == 2


@pytest.mark.parametrize("dims", fb.HEAD_DIMS, ids=str)
def test_smem_mirror_fits_the_card(dims):
    D, Dv = dims
    kv, dq = fb.smem_bytes(D, Dv)
    assert max(kv, dq) <= SMEM_LIMIT
    # the epilogue hands one fp32 accumulator per warpgroup over through
    # the ring's Q and dO stages
    assert (D + Dv) // 2 * 128 * 4 <= fb.STAGES * 2 * fb.BM * (D + Dv)
    # every tile a multiple of the 1024-byte swizzle atom
    assert all(2 * rows * w % 1024 == 0 for rows in (fb.BN, fb.BM, fb.Q_BM)
               for w in (D, Dv))


@pytest.mark.parametrize("G", [1, 5, 8])
@pytest.mark.parametrize("case", SCHEDULES, ids=str)
def test_dkdv_steps_cover_every_visible_pair_once(case, G):
    Sq, Sk, kind, window, off = case
    vis = _visible(Sq, Sk, kind, window, off)
    count = np.zeros((G, Sq, Sk), int)
    for n0 in range(0, Sk, fb.BN):
        steps = fb.dkdv_steps(n0, Sq, Sk, G, kind, window, off)
        assert [wg for _, _, wg, _ in steps] == \
            [i % 2 for i in range(len(steps))]
        for hg, t, wg, edge in steps:
            m0 = t * fb.BM
            rows, keys = slice(m0, m0 + fb.BM), slice(n0, n0 + fb.BN)
            block = vis[rows, keys]
            count[hg, rows, keys] += block
            if not edge:
                assert block.shape == (fb.BM, fb.BN) and block.all()
    assert (count == vis[None]).all()


@pytest.mark.parametrize("case", SCHEDULES, ids=str)
def test_dq_tiles_cover_every_visible_pair_once(case):
    Sq, Sk, kind, window, off = case
    vis = _visible(Sq, Sk, kind, window, off)
    count = np.zeros((Sq, Sk), int)
    for m0 in range(0, Sq, fb.Q_BM):
        for t, wg, sees, edge in fb.dq_tiles(m0, Sq, Sk, kind, window, off):
            m0w, n0 = m0 + fb.BM * wg, t * fb.BN
            rows, keys = slice(m0w, m0w + fb.BM), slice(n0, n0 + fb.BN)
            block = vis[rows, keys]
            if not sees:
                assert not block.any()
                continue
            count[rows, keys] += block
            if not edge:
                assert block.shape == (fb.BM, fb.BN) and block.all()
    assert (count == vis).all()


@pytest.mark.parametrize("case", SCHEDULES, ids=str)
def test_dq_tiles_wide_cover_every_visible_pair_once(case):
    """The wide dQ CTAs of 64 queries: every visible pair once, every tile
    of a CTA's range holds one, no masked pair in an interior tile."""
    Sq, Sk, kind, window, off = case
    vis = _visible(Sq, Sk, kind, window, off)
    count = np.zeros((Sq, Sk), int)
    for m0 in range(0, Sq, fb.BM):
        for t, edge in fb.dq_tiles_wide(m0, Sq, Sk, kind, window, off):
            rows, keys = slice(m0, m0 + fb.BM), slice(t * fb.BN,
                                                       (t + 1) * fb.BN)
            block = vis[rows, keys]
            assert block.any()
            count[rows, keys] += block
            if not edge:
                assert block.shape == (fb.BM, fb.BN) and block.all()
    assert (count == vis).all()


def test_wide_schedule_at_recurrentgemma_training_shape():
    """recurrentgemma-2b's local layers at B 4 x 1024 (10 heads over 1 KV
    head, window 2048 >= S: causal in effect): 64 dK/dV CTAs, key tile 0
    walking 10 x 16 steps and the last 10; 640 dQ CTAs, the last query
    tile's walking all 16 key tiles; the window and the causal mask give
    the same schedule."""
    B, S, G, KV, H = 4, 1024, 10, 1, 10
    n_kv = B * KV * (S // fb.BN)
    n_q = B * H * (S // fb.BM)
    assert (n_kv, n_q) == (64, 640)
    for n0 in (0, S - fb.BN):
        assert fb.dkdv_steps(n0, S, S, G, "window", 2048) == \
            fb.dkdv_steps(n0, S, S, G, "causal")
    assert len(fb.dkdv_steps(0, S, S, G, "window", 2048)) == 160
    assert len(fb.dkdv_steps(S - fb.BN, S, S, G, "window", 2048)) == 10
    assert len(fb.dq_tiles_wide(S - fb.BM, S, S, "window", 2048)) == 16
    assert fb.dq_tiles_wide(0, S, S, "window", 2048) == [(0, True)]


@pytest.mark.parametrize("case", [
    # (B, Sq, Sk, H, KV, mask_kind, window, q_offset, slices)
    (4, 1024, 1024, 10, 1, "window", 2048, 0, 5),   # recurrentgemma: 2 heads
    (4, 1024, 1024, 10, 1, "none", 0, 0, 3),        # every tile 16 steps
    (1, 300, 300, 5, 1, "window", 100, 0, 5),
    (1, 200, 200, 3, 3, "causal", 0, 0, 1),         # G 1
    (1, 8, 8, 2, 2, "window", 2, 20, 1),            # no step at all
    (1, 128, 128, 16, 1, "none", 0, 0, 16),         # too few steps: a head
    (2, 512, 512, 8, 2, "causal", 0, 0, 4),         # GQA, G 4: a head
], ids=str)
def test_wide_splits_fill_the_card(case):
    """The fewest slices of a group's heads whose heaviest dK/dV CTA walks
    no more steps than the grid's average SM: at recurrentgemma-2b's
    training shape 5 slices of 2 heads, 320 CTAs, the heaviest 32 steps
    against 42 an SM (64 CTAs and 160 steps unsliced)."""
    B, Sq, Sk, H, KV, kind, window, off, want = case
    G = H // KV
    splits = fb.wide_splits(B, Sq, Sk, H, KV, kind, window, off, sms=SMS)
    assert splits == want
    n_qt = [len(fb.dkdv_steps(n0, Sq, Sk, 1, kind, window, off))
            for n0 in range(0, Sk, fb.BN)]
    per_sm = -(-B * KV * G * sum(n_qt) // SMS)

    def heaviest(s):
        return -(-G // s) * max(n_qt)

    assert heaviest(splits) <= per_sm or splits == G
    assert all(heaviest(s) > per_sm for s in range(1, splits))
    # every slice holds a head: the slices cover the group exactly
    g_per = -(-G // splits)
    assert (splits - 1) * g_per < G <= splits * g_per


@pytest.mark.parametrize("G", range(1, 17))
def test_slices_cover_their_group_once_in_order(G):
    """The wide dK/dV kernel's slices of a (batch, KV head, key tile): at
    the slice count the wrapper picks for G heads (at recurrentgemma-2b's
    training shape and without a mask), slice r takes the next heads of
    the group, every head once, no slice empty, and the reduce kernel sums
    the slices' parts in that order."""
    for kind in ("window", "none"):
        splits = fb.wide_splits(4, 1024, 1024, G, 1, kind, 2048, sms=SMS)
        heads = fb.slice_heads(G, splits)
        assert len(heads) == splits and all(len(r) for r in heads)
        assert [h for r in heads for h in r] == list(range(G))


def test_dkdv_steps_split_the_yi6b_schedule_between_the_warpgroups():
    """At yi-6b's training shape (S 1024, G 8, causal) key tile 0 walks
    8 x 16 steps, eight per warpgroup and head; the last key tile 8."""
    first = fb.dkdv_steps(0, 1024, 1024, 8, "causal")
    last = fb.dkdv_steps(1024 - fb.BN, 1024, 1024, 8, "causal")
    assert len(first) == 128 and len(last) == 8
    assert sum(wg for *_, wg, _ in first) == 64
    assert sum(edge for *_, edge in first) == 8   # the diagonal tiles


def _bf(t):
    return t.to(torch.bfloat16).float()


def tiled_backward(q, k, v, out, dout, lse, *, mask_kind, window=0,
                   q_offset=0, scale=None):
    """The kernel's arithmetic in its order on the CPU: per dK/dV CTA the
    steps of :func:`dkdv_steps`, each warpgroup's partials summed at the
    end; per dQ CTA the tiles of :func:`dq_tiles`; products of bf16
    operands accumulated in fp32, P and dS rounded to bf16, the mask
    applied only on edge tiles (ragged tiles are cut to the tensors)."""
    B, Sq, H, D = q.shape
    Sk, KV, Dv = k.shape[1], k.shape[2], v.shape[-1]
    G = H // KV
    scale = scale if scale is not None else D ** -0.5
    sl2 = scale * LOG2E
    vis = torch.from_numpy(_visible(Sq, Sk, mask_kind, window, q_offset))
    qf, kf, vf, dof = (t.float() for t in (q, k, v, dout))
    lse2 = lse.float() * LOG2E
    delta = (dof * out.float()).sum(-1)
    dq = torch.zeros(B, Sq, H, D)
    dk = torch.zeros(B, Sk, KV, D)
    dv = torch.zeros(B, Sk, KV, Dv)
    wide = (D, Dv) in fb.WIDE_PAIRS
    # the wide kernel's warpgroups share every step: one accumulator of dK
    # and one of dV a slice of the group's heads, the slices summed in order
    splits = fb.wide_splits(B, Sq, Sk, H, KV, mask_kind, window, q_offset,
                            sms=SMS) if wide else 2
    g_per = -(-G // splits)
    for b in range(B):
        for hk in range(KV):
            for n0 in range(0, Sk, fb.BN):
                keys = slice(n0, n0 + fb.BN)
                nk = min(fb.BN, Sk - n0)
                part = [(torch.zeros(nk, D), torch.zeros(nk, Dv))
                        for _ in range(splits)]
                for hg, t, wg, edge in fb.dkdv_steps(n0, Sq, Sk, G, mask_kind,
                                                     window, q_offset):
                    wg = hg // g_per if wide else wg
                    h, rows = hk * G + hg, slice(t * fb.BM, (t + 1) * fb.BM)
                    st = kf[b, keys, hk] @ qf[b, rows, h].T
                    p = torch.exp2(st * sl2 - lse2[b, rows, h][None])
                    if edge:
                        p = torch.where(vis[rows, keys].T, p, 0.0)
                    dpt = vf[b, keys, hk] @ dof[b, rows, h].T
                    # the wide kernel hands P^T over in bf16
                    ds = (_bf(p) if wide else p) * (dpt - delta[b, rows, h][None])
                    part[wg][1].add_(_bf(p) @ dof[b, rows, h])
                    part[wg][0].add_(_bf(ds) @ qf[b, rows, h])
                dk[b, keys, hk] = sum(p[0] for p in part) * scale
                dv[b, keys, hk] = sum(p[1] for p in part)
        for h in range(H):
            hk = h // G
            if wide:
                for m0 in range(0, Sq, fb.BM):
                    rows = slice(m0, m0 + fb.BM)
                    for t, edge in fb.dq_tiles_wide(m0, Sq, Sk, mask_kind,
                                                    window, q_offset):
                        keys = slice(t * fb.BN, (t + 1) * fb.BN)
                        s = qf[b, rows, h] @ kf[b, keys, hk].T
                        p = torch.exp2(s * sl2 - lse2[b, rows, h][:, None])
                        if edge:
                            p = torch.where(vis[rows, keys], p, 0.0)
                        dp = dof[b, rows, h] @ vf[b, keys, hk].T
                        ds = p * (dp - delta[b, rows, h][:, None])
                        dq[b, rows, h] += _bf(ds) @ kf[b, keys, hk]
                continue
            for m0 in range(0, Sq, fb.Q_BM):
                for t, wg, sees, edge in fb.dq_tiles(m0, Sq, Sk, mask_kind,
                                                     window, q_offset):
                    if not sees:
                        continue
                    m0w, n0 = m0 + fb.BM * wg, t * fb.BN
                    rows, keys = slice(m0w, m0w + fb.BM), slice(n0, n0 + fb.BN)
                    s = qf[b, rows, h] @ kf[b, keys, hk].T
                    p = torch.exp2(s * sl2 - lse2[b, rows, h][:, None])
                    if edge:
                        p = torch.where(vis[rows, keys], p, 0.0)
                    dp = dof[b, rows, h] @ vf[b, keys, hk].T
                    ds = p * (dp - delta[b, rows, h][:, None])
                    dq[b, rows, h] += _bf(ds) @ kf[b, keys, hk]
    dq *= scale
    return tuple(t.to(torch.bfloat16) for t in (dq, dk, dv))


TILED = [
    # (B, Sq, Sk, H, KV, D, mask_kind, window, q_offset)
    (2, 200, 200, 8, 1, 64, "causal", 0, 0),       # G 8, ragged S
    (1, 150, 300, 5, 1, 64, "window", 70, 150),    # G 5, window, offset
    (2, 100, 60, 2, 2, 64, "window", 40, 30),      # G 1, keyless rows
    (1, 77, 190, 4, 2, 128, "none", 0, 0),         # D 128, ragged
    (1, 130, 200, 4, 2, 128, "causal", 0, 70),
    # (256, 256), the wide kernels: MQA G 5 with a window shorter than S,
    # and a ragged causal Sq != Sk with a q_offset
    (1, 150, 150, 5, 1, 256, "window", 70, 0),
    (1, 90, 160, 2, 1, 256, "causal", 0, 70),
]


def _rel_l2(got, want):
    want = want.float()
    return float((got.float() - want).norm() / want.norm().clamp(min=1e-30))


@pytest.mark.parametrize("case", TILED, ids=str)
def test_tiled_arithmetic_matches_the_plain_formula(case):
    B, Sq, Sk, H, KV, D, kind, window, off = case
    _check_tiled(np.random.default_rng(sum(case[:6])), B, Sq, Sk, H, KV, D,
                 D, D, kind, window, off)


TILED_MLA = [
    # (B, Sq, Sk, H, KV, qk, D, Dv, mask_kind, window, q_offset): q and k
    # of width qk zero-padded to D at the scale of qk, as mla_apply runs
    # them.  minicpm3-4b's (96 padded to 128, 64; the split kernels) and
    # deepseek-v2-lite's (192, 128) (the wide kernels, one slice at G 1),
    # causal and ragged with a q_offset, no mask with Sq != Sk, and the
    # wide pair at G 4 (two slices of the group's heads).
    (1, 150, 150, 2, 2, 96, 128, 64, "causal", 0, 0),
    (1, 90, 160, 2, 2, 96, 128, 64, "causal", 0, 70),
    (1, 150, 150, 2, 2, 192, 192, 128, "causal", 0, 0),
    (1, 90, 160, 2, 2, 192, 192, 128, "causal", 0, 70),
    (1, 77, 130, 2, 1, 192, 192, 128, "none", 0, 0),
    (1, 100, 100, 4, 1, 192, 192, 128, "window", 40, 0),
]


@pytest.mark.parametrize("case", TILED_MLA, ids=str)
def test_tiled_arithmetic_matches_the_plain_formula_at_mla_pairs(case):
    _check_tiled(np.random.default_rng(sum(case[:8])), *case)


def _check_tiled(rng, B, Sq, Sk, H, KV, qk, D, Dv, kind, window, off):
    """The tiled emulation against the plain formula in fp32, within the
    card's bound; q and k of width ``qk`` zero-padded to D."""

    def bf16(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(torch.bfloat16)

    def padded(t):
        return torch.cat([t, t.new_zeros(t.shape[:-1] + (D - qk,))], -1)

    q, k, v, dout = padded(bf16(B, Sq, H, qk)), padded(bf16(B, Sk, KV, qk)), \
        bf16(B, Sk, KV, Dv), bf16(B, Sq, H, Dv)
    kw = dict(mask_kind=kind, window=window, q_offset=off, scale=qk ** -0.5)
    out, lse = flash_attention_plain(q.float(), k.float(), v.float(),
                                     return_lse=True, **kw)
    out = out.to(torch.bfloat16)
    got = tiled_backward(q, k, v, out, dout, lse, **kw)
    want = fb.flash_attention_bwd_plain(q, k, v, out, dout, lse, **kw)
    floor = fb.flash_attention_bwd_plain(q, k, v, out, dout, lse,
                                         dtype=torch.bfloat16, **kw)
    for name, g, w, f in zip(("dq", "dk", "dv"), got, want, floor):
        assert g.shape == w.shape and torch.isfinite(g.float()).all(), name
        if not w.float().any():
            assert not g.float().any(), name
            continue
        limit = max(BWD_REL_L2, 2 * _rel_l2(f, w))
        assert _rel_l2(g, w) <= limit, (name, _rel_l2(g, w), limit)
    for g in got[:2]:
        assert not g[..., qk:].float().any(), "padded columns"


@pytest.mark.parametrize("case", [
    # (B, Sq, Sk, H, KV, mask_kind, window, q_offset)
    (1, 40, 40, 4, 1, "window", 16, 0),        # MQA, window < S
    (2, 24, 40, 2, 1, "window", 64, 16),       # window >= S: causal
], ids=str)
def test_plain_backward_at_head_dim_256_matches_jax_vjp(case):
    """The plain formula at (256, 256) with a window and MQA against
    jax.vjp of the reference's flash_attention (XLA custom_vjp), float32,
    within 1e-4."""
    import jax
    import jax.numpy as jnp

    from repro.kernels import ops as jops

    B, Sq, Sk, H, KV, kind, window, off = case
    D = 256
    rng = np.random.default_rng(sum(case[:5]))
    q, k, v = (rng.standard_normal(s, dtype=np.float32)
               for s in ((B, Sq, H, D), (B, Sk, KV, D), (B, Sk, KV, D)))
    g = rng.standard_normal((B, Sq, H, D), dtype=np.float32)

    def fn(q, k, v):
        return jops.flash_attention(q, k, v, mask_kind=kind, window=window,
                                    q_offset=off, backend="xla")

    _, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(g))
    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    kw = dict(mask_kind=kind, window=window, q_offset=off)
    out, lse = flash_attention_plain(tq, tk, tv, return_lse=True, **kw)
    got = fb.flash_attention_bwd_plain(tq, tk, tv, out, tg, lse, **kw)
    for name, w, gt in zip(("dq", "dk", "dv"), want, got):
        assert gt.shape == w.shape, name
        np.testing.assert_allclose(gt.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4, err_msg=name)


@pytest.mark.parametrize("case", [
    # (B, Sq, Sk, H, KV, qk, D, Dv, q_offset): minicpm3-4b's qk 96 run as
    # 128 beside v 64, deepseek-v2-lite's (192, 128); causal, the second
    # of each with Sq != Sk and a q_offset
    (2, 40, 40, 3, 3, 96, 128, 64, 0),
    (1, 24, 40, 2, 2, 96, 128, 64, 16),
    (2, 40, 40, 2, 2, 192, 192, 128, 0),
    (1, 24, 40, 4, 2, 192, 192, 128, 16),
], ids=str)
def test_plain_backward_at_mla_pairs_matches_jax_vjp(case):
    """The plain formula at MLA's pairs, q and k zero-padded from qk to D
    at the scale of qk (as ``mla_apply`` runs them), against jax.vjp of
    the reference's flash_attention (XLA custom_vjp) at the unpadded
    (qk, Dv), float32, within 1e-4; the padded columns of dq and dk are
    exactly zero."""
    import jax
    import jax.numpy as jnp

    from repro.kernels import ops as jops

    B, Sq, Sk, H, KV, qk, D, Dv, off = case
    rng = np.random.default_rng(sum(case[:6]))
    q, k, v = (rng.standard_normal(s, dtype=np.float32)
               for s in ((B, Sq, H, qk), (B, Sk, KV, qk), (B, Sk, KV, Dv)))
    g = rng.standard_normal((B, Sq, H, Dv), dtype=np.float32)
    scale = qk ** -0.5

    def fn(q, k, v):
        return jops.flash_attention(q, k, v, mask_kind="causal",
                                    q_offset=off, scale=scale,
                                    backend="xla")

    _, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(g))

    def padded(a):
        return torch.from_numpy(np.concatenate(
            [a, np.zeros(a.shape[:-1] + (D - qk,), np.float32)], -1))

    tq, tk, tv, tg = padded(q), padded(k), torch.from_numpy(v), \
        torch.from_numpy(g)
    assert (D, Dv) in fb.HEAD_DIMS
    kw = dict(mask_kind="causal", q_offset=off, scale=scale)
    out, lse = flash_attention_plain(tq, tk, tv, return_lse=True, **kw)
    got = fb.flash_attention_bwd_plain(tq, tk, tv, out, tg, lse, **kw)
    for name, w, gt in zip(("dq", "dk", "dv"), want, got):
        assert gt.shape[:-1] == w.shape[:-1], name
        if name != "dv":
            assert not gt[..., qk:].any(), name
        np.testing.assert_allclose(gt[..., :w.shape[-1]].numpy(),
                                   np.asarray(w), rtol=1e-4, atol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("arch,pair,heads,G", [
    ("minicpm3-4b", (128, 64), 40, 1),
    ("deepseek-v2-lite-16b", (192, 128), 16, 1),
])
def test_mla_training_shapes_take_their_pairs(arch, pair, heads, G):
    """At B 4 x 1024 each MLA arch's prefill pads to a pair the backward
    takes (split at minicpm3's, wide at deepseek's), with G 1 (the rope
    key expanded over the heads): every dK/dV CTA walks its key tile's
    query tiles once (key tile 0 sixteen, the last one), the wide kernel
    takes one slice, and the wide dQ CTAs cover each visible pair once."""
    from repro_torch.configs import get_arch
    from repro_torch.models.mla import padded_qk_dim

    cfg = get_arch(arch)
    m = cfg.mla
    assert (padded_qk_dim(m.qk_nope_dim + m.qk_rope_dim, m.v_head_dim),
            m.v_head_dim) == pair
    assert pair in fb.HEAD_DIMS and cfg.n_heads == heads
    S = 1024
    assert len(fb.dkdv_steps(0, S, S, G, "causal")) == S // fb.BM
    assert len(fb.dkdv_steps(S - fb.BN, S, S, G, "causal")) == 1
    kv, dq = fb.smem_bytes(*pair)
    assert max(kv, dq) <= SMEM_LIMIT
    if pair in fb.WIDE_PAIRS:
        assert fb.wide_splits(4, S, S, heads, heads, "causal", sms=SMS) == 1
        vis = _visible(S, S, "causal", 0, 0)
        count = np.zeros((S, S), int)
        for m0 in range(0, S, fb.BM):
            for t, _ in fb.dq_tiles_wide(m0, S, S, "causal"):
                count[m0:m0 + fb.BM, t * fb.BN:(t + 1) * fb.BN] += \
                    vis[m0:m0 + fb.BM, t * fb.BN:(t + 1) * fb.BN]
        assert (count == vis).all()
    else:
        assert (kv, dq) == (125_992, 148_552)


def test_every_mla_pair_of_the_zoo_has_a_backward():
    """Every (D, Dv) that ``mla.padded_qk_dim`` chooses for an MLA arch of
    the zoo, at full width, is one the backward takes: the forward's
    pairs that no model pads to ((64, 128)) need none."""
    from repro_torch.configs import ARCHS, get_arch
    from repro_torch.models.mla import padded_qk_dim

    chosen = set()
    for arch in ARCHS:
        m = get_arch(arch).mla
        if m is not None:
            chosen.add((padded_qk_dim(m.qk_nope_dim + m.qk_rope_dim,
                                      m.v_head_dim), m.v_head_dim))
    assert chosen == {(128, 64), (192, 128)}
    assert chosen <= set(fb.HEAD_DIMS)
