"""The seven CUDA kernels of the model, and the threefry kernel, as
operators (``torch.ops.repro_torch.*``), on the CPU.

Each kernel's launch is an operator: its CUDA implementation launches (on
the card only), its CPU implementation is the plain version laid out as
the kernel lays its outputs, its fake implementation allocates what a
launch allocates without a device, and its flop formula is registered
with ``torch.utils.flop_counter``.  Checked here: every op passes
``torch.library.opcheck`` (schema, fake against CPU implementation,
AOT dispatch; threefry's schema writes into its output, a ``bits`` and
a ``normal`` draw); every fake implementation's outputs and scratch have the
shapes, dtypes and strides that the launch allocates, at every (D, Dv)
pair and group size that a config of the zoo hands to the attention
kernels and at the scans' shapes, with the wide backward's slices
planned for 132 SMs; the flop formulas count what their docstrings
state (the attention ops the plain versions' products); the model's ops
send a CPU tensor to the plain version and a fake tensor to the op.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import intra_op_threads, prng
from repro_torch.configs import ARCHS, get_arch
from repro_torch.kernels import _build, ops, threefry
from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels import flash_attention as fwd
from repro_torch.kernels import flash_attention_bwd as bwd
from repro_torch.kernels import rglru_scan as rg
from repro_torch.kernels import rglru_scan_bwd as rgb
from repro_torch.kernels import ssd_scan as sd
from repro_torch.kernels import ssd_scan_bwd as sdb
from repro_torch.models import lm
from repro_torch.models.mla import padded_qk_dim


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The module's CPU work on one intra-op thread: its small products
    would wake every thread, which under the suite's parallel workers
    makes them many times slower (the rule of ``README.md``'s "Tests on
    the CPU")."""
    with intra_op_threads(1):
        yield


OPS = ("flash_attention", "flash_attention_bwd", "decode_attention",
       "ssd_scan", "ssd_scan_bwd", "rglru_scan", "rglru_scan_bwd")
BF16, F32 = torch.bfloat16, torch.float32


def _t(rng, shape, dtype=BF16, scale=1.0):
    return torch.from_numpy(
        (rng.standard_normal(shape) * scale).astype(np.float32)).to(dtype)


def _attention(rng, B, Sq, Sk, H, KV, D, Dv):
    return (_t(rng, (B, Sq, H, D)), _t(rng, (B, Sk, KV, D)),
            _t(rng, (B, Sk, KV, Dv)))


def _ssd(rng, B, S, H, P, G, N, init):
    return (_t(rng, (B, S, H, P), scale=0.5),
            torch.from_numpy(rng.uniform(0.01, 0.2, (B, S, H))
                             .astype(np.float32)),
            -torch.from_numpy(rng.uniform(0.5, 2.0, (H,)).astype(np.float32)),
            _t(rng, (B, S, G, N), scale=0.3), _t(rng, (B, S, G, N),
                                                   scale=0.3),
            _t(rng, (B, H, P, N), F32, 0.2) if init else None)


def _rglru(rng, B, S, C, init):
    u = rng.uniform(0.05, 0.95, (2, B, S, C)).astype(np.float32)
    return (_t(rng, (B, S, C)), torch.from_numpy(u[0]),
            torch.from_numpy(u[1]),
            -torch.from_numpy(rng.uniform(0.1, 1.0, (C,)).astype(np.float32)),
            _t(rng, (B, C), F32) if init else None)


def _cases():
    """(op name, args) for opcheck: every op, its optional outputs and
    inputs both ways."""
    rng = np.random.default_rng(0)
    out = []
    for mask, window, offset, lse in (("causal", 0, 0, True),
                                      ("window", 5, 3, False),
                                      ("none", 0, 0, True)):
        q, k, v = _attention(rng, 2, 9, 12, 4, 2, 64, 64)
        out.append(("flash_attention",
                    (q, k, v, mask, window, offset, 0.125, lse)))
    for (D, Dv), KV in (((64, 64), 2), ((256, 256), 1)):
        q, k, v = _attention(rng, 1, 70, 70, 4, KV, D, Dv)
        o, do = _t(rng, (1, 70, 4, Dv)), _t(rng, (1, 70, 4, Dv))
        lse = _t(rng, (1, 70, 4), F32) + 3.0
        out.append(("flash_attention_bwd",
                    (q, k, v, o, do, lse, "causal", 0, 0, D ** -0.5)))
    for lse in (True, False):
        q = _t(rng, (3, 4, 64))
        kc, vc = _t(rng, (3, 40, 2, 64)), _t(rng, (3, 40, 2, 64))
        n = torch.tensor([5, 0, 40], dtype=torch.int32)
        out.append(("decode_attention", (q, kc, vc, n, 0.125, lse)))
    for init, chunk in ((True, 16), (False, 8)):
        x, dt, A, Bm, Cm, h0 = _ssd(rng, 1, 32, 4, 16, 2, 8, init)
        out.append(("ssd_scan", (x, dt, A, Bm, Cm, h0, chunk)))
        dy = _t(rng, (1, 32, 4, 16))
        ds = _t(rng, (1, 4, 16, 8), F32) if init else None
        out.append(("ssd_scan_bwd", (x, dt, A, Bm, Cm, dy, ds, h0, chunk)))
    for init in (True, False):
        x, ga, gi, la, h0 = _rglru(rng, 2, 70, 8, init)
        out.append(("rglru_scan", (x, ga, gi, la, h0, 8.0, init)))
        dh = _t(rng, (2, 70, 8))
        ent = _t(rng, (2, 2, 8), F32)
        out.append(("rglru_scan_bwd",
                    (x, ga, gi, la, dh, h0, ent, h0, 8.0)))
    # threefry writes into its first argument (``Tensor(a!) out``)
    out.append(("threefry", (torch.empty(300, dtype=torch.int32),
                             *threefry._op_args(prng.key(3), "bits", 0.0,
                                                1.0, 1.0, False, False,
                                                2 ** 32 - 100))))
    out.append(("threefry", (torch.empty((3, 100), dtype=BF16),
                             *threefry._op_args(prng.key(4), "normal", 0.0,
                                                1.0, 0.02, False, False,
                                                7))))
    return out


CASES = _cases()


def test_every_kernel_is_an_op():
    assert set(ops.KERNELS) == set(OPS)
    for name in OPS:
        packet = getattr(torch.ops.repro_torch, name)
        assert packet.default.namespace == _build.NAMESPACE
        assert torch._C._dispatch_has_kernel_for_dispatch_key(
            packet.default.name(), "CUDA")


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(CASES)])
def test_opcheck(i):
    name, args = CASES[i]
    torch.library.opcheck(getattr(torch.ops.repro_torch, name).default,
                          args)


def _fake_call(fn, *args, **kwargs):
    """``fn`` under ``FakeTensorMode`` on fake copies of ``args`` (None and
    non-tensors as they are): ``(outputs, [scratch tensors])``."""
    scratch = []
    with FakeTensorMode() as mode, _build.watch_scratch(scratch.extend):
        fake = [mode.from_tensor(a) if isinstance(a, torch.Tensor) else a
                for a in args]
        got = fn(*fake, **kwargs)
    return got, scratch


def _zeros(*shape, dtype=BF16):
    return torch.zeros(shape, dtype=dtype)


def _layout(t, shape, dtype):
    """``t`` is a fresh contiguous tensor of ``shape`` and ``dtype``."""
    assert tuple(t.shape) == tuple(shape), (tuple(t.shape), shape)
    assert t.dtype == dtype
    assert t.is_contiguous() and t.storage_offset() == 0


def _attention_cases(cfg):
    """The (D, Dv, H, KV) that ``cfg``'s layers hand to flash and its
    backward, and the (D, Dv, H, KV) they hand to decode (MLA decodes with
    plain products)."""
    flash, decode = set(), set()
    hd = cfg.head_dim_
    for stage in lm.build_plan(cfg):
        for spec in stage.unit:
            if spec.mixer in ("gqa", "local"):
                flash.add((hd, hd, cfg.n_heads, cfg.n_kv_heads))
                decode.add((hd, hd, cfg.n_heads, cfg.n_kv_heads))
            elif spec.mixer == "mla":
                m = cfg.mla
                qk = padded_qk_dim(m.qk_nope_dim + m.qk_rope_dim,
                                   m.v_head_dim)
                flash.add((qk, m.v_head_dim, cfg.n_heads, cfg.n_heads))
    if cfg.encoder is not None:        # the encoder's and cross attention
        flash.add((hd, hd, cfg.n_heads, cfg.n_heads))
    return sorted(flash), sorted(decode)


ZOO = [(arch, reduced) for arch in sorted(ARCHS) for reduced in (False,
                                                                  True)]


@pytest.mark.parametrize("arch,reduced", ZOO, ids=str)
def test_attention_fakes_allocate_what_the_launch_does(arch, reduced):
    """Flash (out, and the fp32 lse on the training path; nothing else),
    its backward (dq, dk, dv; lse and delta [B, H, 2, Sq padded to 64]
    fp32; the wide pairs' fp32 parts of dK then dV when the heads of a
    group take more than one slice on 132 SMs) and decode (out, the
    optional lse, the split partials planned for 132 SMs), at every pair
    and group size of the config, on a ragged B 2 x 77 (decode: 130
    slots)."""
    cfg = get_arch(arch).reduced() if reduced else get_arch(arch)
    flash, decode = _attention_cases(cfg)
    B, S = 2, 77
    for D, Dv, H, KV in flash:
        q, k, v = _zeros(B, S, H, D), _zeros(B, S, KV, D), _zeros(B, S, KV,
                                                                   Dv)
        for lse in (False, True):
            (out, l), scratch = _fake_call(fwd.OP, q, k, v, "causal", 0, 0,
                                           D ** -0.5, lse)
            _layout(out, (B, S, H, Dv), BF16)
            _layout(l, (B, S, H) if lse else (0,), F32)
            assert scratch == []
        grads, scratch = _fake_call(
            bwd.OP, q, k, v, _zeros(B, S, H, Dv), _zeros(B, S, H, Dv),
            _zeros(B, S, H, dtype=F32), "causal", 0, 0, D ** -0.5)
        for g, like in zip(grads, (q, k, v)):
            _layout(g, like.shape, BF16)
        splits = bwd.wide_splits(B, S, S, H, KV, "causal", sms=132) \
            if (D, Dv) in bwd.WIDE_PAIRS else 1
        _layout(scratch[0], (B, H, 2, 128), F32)
        assert len(scratch) == (2 if splits > 1 else 1)
        if splits > 1:
            _layout(scratch[1], (splits * B * S * KV * (D + Dv),), F32)
    for D, Dv, H, KV in decode:
        slots = 130
        q = _zeros(B, H, D)
        kc, vc = _zeros(B, slots, KV, D), _zeros(B, slots, KV, Dv)
        n = torch.zeros(B, dtype=torch.int32)
        for lse in (False, True):
            (out, l), scratch = _fake_call(dec.OP, q, kc, vc, n, D ** -0.5,
                                           lse)
            _layout(out, (B, H, Dv), BF16)
            _layout(l, (B, H) if lse else (0,), F32)
            n_split, _ = dec.plan(slots, D, Dv, H // KV, B * KV, 132)
            (part,) = scratch
            _layout(part, (B * KV * n_split * (H // KV) * (Dv + 2),), F32)


def test_wide_backward_slices_are_planned_for_132_sms():
    """recurrentgemma-2b's training shape (B 4 x 1024, 10 heads over 1 of
    256, window 2048) takes its group in 5 slices of 2 heads (320 CTAs),
    whose fp32 parts of dK and dV the fake allocates; deepseek-v2-lite's
    (16 heads over 16 of (192, 128): G 1) one slice and no parts."""
    B, S = 4, 1024
    for (D, Dv, H, KV, mask, window), splits in (
            ((256, 256, 10, 1, "window", 2048), 5),
            ((192, 128, 16, 16, "causal", 0), 1)):
        assert bwd.wide_splits(B, S, S, H, KV, mask, window, sms=132) \
            == splits
        q, k, v = _zeros(B, S, H, D), _zeros(B, S, KV, D), _zeros(B, S, KV,
                                                                   Dv)
        _, scratch = _fake_call(
            bwd.OP, q, k, v, _zeros(B, S, H, Dv), _zeros(B, S, H, Dv),
            _zeros(B, S, H, dtype=F32), mask, window, 0, D ** -0.5)
        want = [((B, H, 2, S), F32)]
        if splits > 1:
            want.append(((splits * B * S * KV * (D + Dv),), F32))
        assert [(tuple(t.shape), t.dtype) for t in scratch] == want


@pytest.mark.parametrize("reduced", [False, True])
def test_scan_fakes_allocate_what_the_launch_does(reduced):
    """The SSD scan (y bf16, state fp32; no scratch) and its backward (the
    gradients in their inputs' dtypes, dh0 fp32 or empty; the states
    entering and leaving each chunk bf16 [B, H, nc, P padded to 64, N
    padded to 16], dt and cum fp32 [B, H, nc, 2, chunk padded to 64], the
    per-slice dB and dC partials fp32 [B, S, G x slices, N] with the
    slices of ``plan`` on 132 SMs, dA's fp32 [B, H, nc]) at mamba2-2.7b's
    head; the RG-LRU scan (h bf16, state fp32, the entering states fp32
    [B, ceil(S / 64), C] or empty; no scratch) and its backward (the
    gradients, d initial_state fp32 or empty; each row's d log_a fp32 [B,
    C]) at recurrentgemma-2b's width; B 4 x 256."""
    mamba = get_arch("mamba2-2.7b")
    rgem = get_arch("recurrentgemma-2b")
    if reduced:
        mamba, rgem = mamba.reduced(), rgem.reduced()
    s = mamba.ssm
    B, S = 4, 256
    H, P, G, N = s.d_inner // s.head_dim, s.head_dim, s.n_groups, s.state_dim
    Q = min(s.chunk, S)
    x, dt, A = _zeros(B, S, H, P), _zeros(B, S, H, dtype=F32), _zeros(
        H, dtype=F32)
    Bm, Cm = _zeros(B, S, G, N), _zeros(B, S, G, N)
    h0 = _zeros(B, H, P, N, dtype=F32)
    for init in (None, h0):
        (y, state), scratch = _fake_call(sd.OP, x, dt, A, Bm, Cm, init, Q)
        _layout(y, x.shape, BF16)
        _layout(state, (B, H, P, N), F32)
        assert scratch == []
        grads, scratch = _fake_call(sdb.OP, x, dt, A, Bm, Cm, x, init, init,
                                    Q)
        for g, like in zip(grads, (x, dt, A, Bm, Cm)):
            _layout(g, like.shape, like.dtype)
        _layout(grads[5], (B, H, P, N) if init is not None else (0,), F32)
        Qk = sdb.kernel_chunk(Q, P, N)
        nc = S // Qk
        R = sdb.plan(B, nc, H, G, 132)
        n_sl = -(-(H // G) // R)
        r64, r16 = (lambda v: -(-v // 64) * 64), (lambda v: -(-v // 16) * 16)
        want = [((B, H, nc, r64(P), r16(N)), BF16)] * 2 + [
            ((B, H, nc, 2, r64(Qk)), F32), ((B, S, G * n_sl, N), F32),
            ((B, S, G * n_sl, N), F32), ((B, H, nc), F32)]
        assert [(tuple(t.shape), t.dtype) for t in scratch] == want
        for t in scratch:
            assert t.is_contiguous()
    if not reduced:                    # mamba2's training shape: R 20
        assert sdb.plan(4, 8, 80, 1, 132) == 20
    C = rgem.rglru.width
    x, ga = _zeros(B, S, C), _zeros(B, S, C, dtype=F32)
    la, h0 = _zeros(C, dtype=F32), _zeros(B, C, dtype=F32)
    for init in (None, h0):
        for entering in (False, True):
            (h, state, ent), scratch = _fake_call(rg.OP, x, ga, ga, la, init,
                                                  8.0, entering)
            _layout(h, x.shape, BF16)
            _layout(state, (B, C), F32)
            _layout(ent, (B, S // 64, C) if entering else (0,), F32)
            assert scratch == []
        ent = _zeros(B, S // 64, C, dtype=F32)
        grads, scratch = _fake_call(rgb.OP, x, ga, ga, la, x, init, ent,
                                    init, 8.0)
        for g, like in zip(grads, (x, ga, ga, la)):
            _layout(g, like.shape, like.dtype)
        _layout(grads[4], (B, C) if init is not None else (0,), F32)
        (partial,) = scratch
        _layout(partial, (B, C), F32)


def _counted(fn, *args, **kwargs) -> int:
    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return counter.get_total_flops()


@pytest.mark.parametrize("G,D,Dv", [(1, 64, 64), (4, 128, 128),
                                    (7, 128, 128), (1, 192, 128)])
def test_attention_flops_are_the_plain_products(G, D, Dv):
    """Under ``FlopCounterMode`` the flash, backward and decode ops count
    what their plain versions' products count (the forward with and
    without the lse; the backward's five products)."""
    rng = np.random.default_rng(G * 1000 + D)
    B, S, KV = 2, 33, 2
    q, k, v = _attention(rng, B, S, S, KV * G, KV, D, Dv)
    for lse in (False, True):
        assert _counted(fwd.OP, q, k, v, "causal", 0, 0, 0.1, lse) == \
            _counted(fwd.flash_attention_plain, q, k, v, return_lse=lse)
    out, lse = fwd.flash_attention_plain(q, k, v, return_lse=True)
    do = _t(rng, out.shape)
    assert _counted(bwd.OP, q, k, v, out, do, lse, "causal", 0, 0, 0.1) \
        == _counted(bwd.flash_attention_bwd_plain, q, k, v, out, do, lse) \
        == 2 * B * KV * G * S * S * (3 * D + 2 * Dv)
    qd, n = q[:, 0].contiguous(), torch.tensor([5, 33], dtype=torch.int32)
    for lse in (False, True):
        assert _counted(dec.OP, qd, k, v, n, 0.1, lse) == _counted(
            dec.decode_attention_plain, qd, k, v, n, return_lse=lse)


def test_scan_flops_are_the_kernels_products():
    """The SSD scan at mamba2-2.7b's serving prefill (B 4 x 1024, 80 heads
    of P 64, N 128, chunk 128): per (batch, head, chunk) the 36 16 x 16
    blocks on and below the diagonal of C B^T and L x and the two state
    products; its backward the design count of ``ssd_scan_bwd.flops`` on
    132 SMs; the RG-LRU ops none."""
    B, S, H, P, N, Q = 4, 1024, 80, 64, 128, 128
    per_chunk = 36 * 256 * (N + P) + 2 * Q * P * N
    assert sd.flops((B, S, H, P), (B, S, H), (H,), (B, S, 1, N),
                    (B, S, 1, N), None, Q) == 2 * B * H * (S // Q) * per_chunk
    rng = np.random.default_rng(3)
    args = _ssd(rng, 1, 32, 4, 16, 2, 8, True)
    assert _counted(sd.OP, *args, 16) == sd.flops(
        *(None if a is None else tuple(a.shape) for a in args), 16)
    dy = _t(rng, (1, 32, 4, 16))
    assert _counted(sdb.OP, *args[:5], dy, None, args[5], 16) == int(
        sdb.flops(1, 32, 4, 16, 2, 8, 16, 132)[1])
    x, ga, gi, la, h0 = _rglru(rng, 1, 40, 8, True)
    assert _counted(rg.OP, x, ga, gi, la, h0, 8.0, True) == 0


def test_ops_send_cpu_tensors_to_the_plain_versions(monkeypatch):
    """On the CPU the model's ops never reach an operator (the plain
    versions run: no launch counted, values the plain version's); under
    ``FakeTensorMode`` the kernel backend reaches the operators and the
    ``ref`` backend does not."""
    reached = []

    def spy(name, real):
        def wrapped(*args, **kwargs):
            reached.append(name)
            return real(*args, **kwargs)
        return wrapped

    for name in ("flash_attention_op", "decode_attention_op", "ssd_op",
                 "rglru_op"):
        monkeypatch.setattr(ops, name, spy(name, getattr(ops, name)))
    rng = np.random.default_rng(5)
    q, k, v = _attention(rng, 1, 16, 16, 4, 2, 64, 64)
    n = torch.tensor([7], dtype=torch.int32)
    sargs = _ssd(rng, 1, 32, 4, 16, 1, 8, False)[:5]
    rargs = _rglru(rng, 1, 16, 8, False)[:4]

    def run(backend):
        out = ops.flash_attention(q, k, v, backend=backend)
        ops.decode_attention(q[:, 0].contiguous(), k, v, n, backend=backend)
        ops.ssd(*sargs, chunk=8, backend=backend)
        ops.rglru(*rargs, backend=backend)
        return out

    ops.reset_launch_counts()
    got = run("kernel")
    assert reached == [] and sum(ops.launch_counts().values()) == 0
    assert torch.equal(got, fwd.flash_attention_plain(q, k, v))
    with FakeTensorMode() as mode:
        q, k, v, n = (mode.from_tensor(t) for t in (q, k, v, n))
        sargs = [mode.from_tensor(t) for t in sargs]
        rargs = [mode.from_tensor(t) for t in rargs]
        run("ref")
        assert reached == []
        run("kernel")
    assert reached == ["flash_attention_op", "decode_attention_op",
                       "ssd_op", "rglru_op"]
    assert sum(ops.launch_counts().values()) == 0
