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
                   q_offset=0):
    """The kernel's arithmetic in its order on the CPU: per dK/dV CTA the
    steps of :func:`dkdv_steps`, each warpgroup's partials summed at the
    end; per dQ CTA the tiles of :func:`dq_tiles`; products of bf16
    operands accumulated in fp32, P and dS rounded to bf16, the mask
    applied only on edge tiles (ragged tiles are cut to the tensors)."""
    B, Sq, H, D = q.shape
    Sk, KV, Dv = k.shape[1], k.shape[2], v.shape[-1]
    G = H // KV
    scale = D ** -0.5
    sl2 = scale * LOG2E
    vis = torch.from_numpy(_visible(Sq, Sk, mask_kind, window, q_offset))
    qf, kf, vf, dof = (t.float() for t in (q, k, v, dout))
    lse2 = lse.float() * LOG2E
    delta = (dof * out.float()).sum(-1)
    dq = torch.zeros(B, Sq, H, D)
    dk = torch.zeros(B, Sk, KV, D)
    dv = torch.zeros(B, Sk, KV, Dv)
    for b in range(B):
        for hk in range(KV):
            for n0 in range(0, Sk, fb.BN):
                keys = slice(n0, n0 + fb.BN)
                nk = min(fb.BN, Sk - n0)
                part = [(torch.zeros(nk, D), torch.zeros(nk, Dv))
                        for _ in range(2)]
                for hg, t, wg, edge in fb.dkdv_steps(n0, Sq, Sk, G, mask_kind,
                                                     window, q_offset):
                    h, rows = hk * G + hg, slice(t * fb.BM, (t + 1) * fb.BM)
                    st = kf[b, keys, hk] @ qf[b, rows, h].T
                    p = torch.exp2(st * sl2 - lse2[b, rows, h][None])
                    if edge:
                        p = torch.where(vis[rows, keys].T, p, 0.0)
                    dpt = vf[b, keys, hk] @ dof[b, rows, h].T
                    ds = p * (dpt - delta[b, rows, h][None])
                    part[wg][1].add_(_bf(p) @ dof[b, rows, h])
                    part[wg][0].add_(_bf(ds) @ qf[b, rows, h])
                dk[b, keys, hk] = (part[0][0] + part[1][0]) * scale
                dv[b, keys, hk] = part[0][1] + part[1][1]
        for h in range(H):
            hk = h // G
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
]


def _rel_l2(got, want):
    want = want.float()
    return float((got.float() - want).norm() / want.norm().clamp(min=1e-30))


@pytest.mark.parametrize("case", TILED, ids=str)
def test_tiled_arithmetic_matches_the_plain_formula(case):
    B, Sq, Sk, H, KV, D, kind, window, off = case
    rng = np.random.default_rng(sum(case[:6]))

    def bf16(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(torch.bfloat16)

    q, k, v, dout = bf16(B, Sq, H, D), bf16(B, Sk, KV, D), \
        bf16(B, Sk, KV, D), bf16(B, Sq, H, D)
    kw = dict(mask_kind=kind, window=window, q_offset=off)
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
