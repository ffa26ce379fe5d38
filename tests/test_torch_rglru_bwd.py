"""The RG-LRU scan's backward in the port, on the CPU.

The same numpy inputs (drawn from ``default_rng``) go through the port's
plain backward (``rglru_scan_bwd.rglru_bwd_plain``), through ``ops.rglru``
under autograd (``ops.RGLRUScan``, which takes the plain versions for CPU
tensors) and through ``jax.vjp`` of the JAX package's ``ops.rglru``: its
XLA two-level scan and its sequential oracle (``backend="ref"``).  In
float32 every gradient (x, both gates, log_a, the initial state) agrees
within 1e-4 relative L2: the same formula summed in another order.  Where
1 - exp(2 L) <= 0 the port takes the derivative of beta as 0 and the
reference's autodiff gives inf or NaN (``ROADMAP.md`` C4); a JAX scan
written with that rule holds the port there.  The fp32 states entering
each chunk, which the forward hands the backward kernel, are held to the
reference's states.  The CUDA kernel itself runs only on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``); here its geometry is
held to the source.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import _build, ops
from repro_torch.kernels import rglru_scan_bwd as rb
from repro_torch.kernels.rglru_scan import rglru_plain

F32_REL_L2 = 1e-4
GRADS = ("dx", "d gate_a", "d gate_i", "d log_a", "dh0")

CASES = [
    # (B, S, C, initial_state, final-state cotangent, log_a scale,
    #  gate_a scale)
    (1, 16, 8, False, False, 1.0, 1.0),
    (2, 37, 12, True, True, 1.0, 1.0),      # ragged S and C, both states
    (2, 70, 5, True, False, 1.0, 1.0),      # over one 64-step chunk
    (3, 9, 33, False, True, 1.0, 1.0),      # cotangent only, C past a tile
    (2, 40, 8, True, True, 100.0, 1.0),     # strong decay: a underflows
    (2, 24, 8, True, True, 1.0, 1e-2),      # gates near 0: beta small
]


def _inputs(case, seed):
    """numpy float32 x, gate_a, gate_i, log_a, dh, the final state's
    cotangent (None without) and the initial state (None without)."""
    B, S, C, init, dstate, decay, ga_scale = case
    rng = np.random.default_rng(seed)
    f32 = np.float32

    def sigmoid(a):
        return (1.0 / (1.0 + np.exp(-a))).astype(f32)

    x = rng.standard_normal((B, S, C), dtype=f32) * 0.5
    ga = sigmoid(rng.standard_normal((B, S, C), dtype=f32)) * f32(ga_scale)
    gi = sigmoid(rng.standard_normal((B, S, C), dtype=f32))
    la = (-np.log1p(np.exp(rng.standard_normal((C,), dtype=f32)))
          * f32(decay)).astype(f32)
    dh = rng.standard_normal((B, S, C), dtype=f32)
    ds = rng.standard_normal((B, C), dtype=f32) if dstate else None
    h0 = rng.standard_normal((B, C), dtype=f32) if init else None
    return x, ga, gi, la, dh, ds, h0


def _jax_grads(arrays, backend, fn=None):
    """jax.vjp of the JAX package's ops.rglru (or ``fn`` of the same
    signature): the gradients of x, gate_a, gate_i, log_a and (if any)
    the initial state, as numpy arrays, None for a missing state."""
    x, ga, gi, la, dh, ds, h0 = arrays
    primals = [jnp.asarray(a) for a in (x, ga, gi, la)]
    if h0 is not None:
        primals.append(jnp.asarray(h0))

    def f(*p):
        if fn is not None:
            return fn(*p[:4], p[4] if h0 is not None else None)
        return jops.rglru(*p[:4], initial_state=p[4] if h0 is not None
                          else None, backend=backend)

    _, vjp = jax.vjp(f, *primals)
    ct_state = jnp.asarray(ds) if ds is not None \
        else jnp.zeros(x.shape[::2], jnp.float32)
    grads = [np.asarray(g) for g in vjp((jnp.asarray(dh), ct_state))]
    return grads + [None] * (5 - len(grads))


def _port_grads(arrays):
    x, ga, gi, la, dh, ds, h0 = (None if a is None else torch.from_numpy(a)
                                 for a in arrays)
    return rb.rglru_bwd_plain(x, ga, gi, la, dh, ds, initial_state=h0)


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("backend", ["xla", "ref"])
@pytest.mark.parametrize("case", CASES, ids=str)
def test_plain_backward_matches_jax_vjp(case, backend):
    arrays = _inputs(case, 400 + CASES.index(case))
    want = _jax_grads(arrays, backend)
    got = _port_grads(arrays)
    for name, g, w in zip(GRADS, got, want):
        if w is None:
            assert g is None, name
            continue
        g = g.numpy()
        assert g.shape == w.shape and np.isfinite(g).all(), name
        assert _rel_l2(g, w) <= F32_REL_L2, (name, _rel_l2(g, w))


@pytest.mark.parametrize("case", [
    (2, 200, 12, True, False, 1.0, 1.0),    # ragged S, an initial state
    (1, 128, 8, False, False, 1.0, 1.0),    # whole chunks, from zeros
    (2, 70, 5, True, False, 100.0, 1.0),    # strong decay, ragged C
    (2, 0, 6, True, False, 1.0, 1.0),       # S 0: no chunk
], ids=str)
def test_plain_entering_states_match_the_reference(case):
    """rglru_plain(entering=True), the forward chunk by chunk: the state
    entering chunk k is the JAX reference's (``backend="ref"``) fp32 h at
    step 64 k - 1, and the initial state (or zeros) at chunk 0, within
    1e-6 relative L2; h and the final state are bitwise those without
    it."""
    x, ga, gi, la, _, _, h0 = _inputs(case, 600 + case[1])
    B, S, C = x.shape
    t = [None if a is None else torch.from_numpy(a)
         for a in (x, ga, gi, la, h0)]
    h, state, entering = rglru_plain(*t[:4], initial_state=t[4],
                                     entering=True)
    want_h, want_state = rglru_plain(*t[:4], initial_state=t[4])
    assert torch.equal(h, want_h) and torch.equal(state, want_state)
    nc = -(-S // rb.CHUNK)
    assert entering.shape == (B, nc, C) and entering.dtype == torch.float32
    ref_h, _ = jops.rglru(*(jnp.asarray(a) for a in (x, ga, gi, la)),
                          initial_state=None if h0 is None
                          else jnp.asarray(h0), backend="ref")
    ref_h = np.asarray(ref_h)
    first = h0 if h0 is not None else np.zeros((B, C), np.float32)
    want = np.stack([first] + [ref_h[:, k * rb.CHUNK - 1]
                               for k in range(1, nc)], 1)[:, :nc]
    if nc:
        assert _rel_l2(entering.numpy(), want) <= 1e-6
        assert np.array_equal(entering[:, 0].numpy(), first)


def test_empty_sequence_passes_the_state_cotangent_through():
    """S 0: no step, every sequence gradient empty, d log_a zero and the
    initial state's gradient the final state's cotangent."""
    arrays = _inputs((2, 0, 6, True, True, 1.0, 1.0), 7)
    dx, dga, dgi, dla, dh0 = _port_grads(arrays)
    assert dx.shape == dga.shape == dgi.shape == (2, 0, 6)
    assert not dla.any()
    assert torch.equal(dh0, torch.from_numpy(arrays[5]))


def _rglru_zero_rule(x, ga, gi, la, h0, c=8.0):
    """The reference's sequential scan with beta's derivative taken as 0
    where 1 - exp(2 L) <= 0 (the port's rule), written in JAX."""
    B, S, C = x.shape
    h = h0 if h0 is not None else jnp.zeros((B, C), jnp.float32)

    def step(h, inp):
        xt, rt, it = inp
        log_at = c * la[None] * rt
        u = 1.0 - jnp.exp(2.0 * log_at)
        beta = jnp.where(u > 0, jnp.sqrt(jnp.where(u > 0, u, 1.0)), 0.0)
        h = jnp.exp(log_at) * h + beta * (it * xt)
        return h, h

    hT, hs = jax.lax.scan(step, h, (jnp.moveaxis(x, 1, 0),
                                    jnp.moveaxis(ga, 1, 0),
                                    jnp.moveaxis(gi, 1, 0)))
    return jnp.moveaxis(hs, 0, 1), hT


def test_rule_where_beta_is_zero():
    """gate_a = 0 at some steps: L = 0, 1 - exp(2 L) = 0, beta = 0.  The
    reference's autodiff gives a non-finite d gate_a exactly there (the
    gradient of sqrt at 0) and so a non-finite d log_a; the port stays
    finite, equals the reference at every other step, and equals a JAX
    scan with beta's derivative taken as 0 everywhere."""
    arrays = list(_inputs((2, 30, 8, True, True, 1.0, 1.0), 11))
    rng = np.random.default_rng(12)
    zero = rng.random(arrays[1].shape) < 0.2
    arrays[1] = np.where(zero, np.float32(0.0), arrays[1])
    got = [None if g is None else g.numpy() for g in _port_grads(arrays)]
    ref = _jax_grads(arrays, "ref")
    rule = _jax_grads(arrays, None, _rglru_zero_rule)
    assert all(np.isfinite(g).all() for g in got)
    assert not np.isfinite(ref[1][zero]).any()
    assert np.isfinite(ref[1][~zero]).all()
    assert not np.isfinite(ref[3]).all()
    for name, g, r, w in zip(GRADS, got, ref, rule):
        assert _rel_l2(g, w) <= F32_REL_L2, (name, _rel_l2(g, w))
        if name == "d gate_a":
            g, r = g[~zero], r[~zero]
        if name != "d log_a":
            assert _rel_l2(g, r) <= F32_REL_L2, (name, _rel_l2(g, r))


@pytest.mark.parametrize("init", [False, True], ids=["zero", "init"])
def test_ops_rglru_under_grad_takes_the_plain_backward(init):
    """Under grad, ops.rglru on CPU tensors goes through RGLRUScan: its
    forward is bitwise the plain scan's (and the same without grad), it
    saves no entering states (None: only the kernels use them) and its
    gradients are bitwise the plain backward's; no kernel launches."""
    arrays = _inputs((2, 20, 6, init, True, 1.0, 1.0), 21)
    x, ga, gi, la, dh, ds, h0 = (None if a is None else torch.from_numpy(a)
                                 for a in arrays)
    leaves = [t.clone().requires_grad_() for t in (x, ga, gi, la)]
    h0g = h0.clone().requires_grad_() if h0 is not None else None
    ops.reset_launch_counts()
    h, state = ops.rglru(*leaves, initial_state=h0g)
    assert h.grad_fn.saved_tensors[-1] is None
    torch.autograd.backward((h, state), (dh, ds))
    want_h, want_state = rglru_plain(x, ga, gi, la, initial_state=h0)
    assert torch.equal(h.detach(), want_h)
    assert torch.equal(state.detach(), want_state)
    with torch.no_grad():
        nh, nstate = ops.rglru(x, ga, gi, la, initial_state=h0)
    assert torch.equal(nh, want_h) and torch.equal(nstate, want_state)
    want = rb.rglru_bwd_plain(x, ga, gi, la, dh, ds, initial_state=h0)
    for name, t, w in zip(GRADS, leaves + [h0g], want):
        if w is None:
            assert t is None
            continue
        assert torch.equal(t.grad, w), name
    assert not any(ops.launch_counts().values())


def test_unused_final_state_has_no_cotangent():
    """The model uses h and drops the final state: its gradients are
    those of a zero final-state cotangent."""
    arrays = _inputs((1, 12, 4, False, False, 1.0, 1.0), 31)
    x, ga, gi, la, dh, _, _ = (None if a is None else torch.from_numpy(a)
                               for a in arrays)
    xg = x.clone().requires_grad_()
    h, _ = ops.rglru(xg, ga, gi, la)
    h.backward(dh)
    assert torch.equal(xg.grad, rb.rglru_bwd_plain(x, ga, gi, la, dh)[0])


def _bwd_by_chunks(x, ga, gi, la, dh, ds, h0, c=8.0):
    """The kernel's order of arithmetic on the CPU (float32): chunks of
    CHUNK steps, warps of CHUNK / WARPS; the forward walk composes each
    warp's map and the last warp rescans; the backward walk recomputes
    h_{t-1} from the maps of the warps before, composes reverse maps of
    carry = a_t g_t and applies those of the warps after, from the last."""
    B, S, C = x.shape
    T, W = rb.CHUNK, rb.WARPS
    sub = T // W
    nc = -(-S // T)
    pad = nc * T - S

    def padded(t):
        return torch.nn.functional.pad(t, (0, 0, 0, pad))

    xf, rf, if_, dhf = (padded(t.float()) for t in (x, ga, gi, dh))
    lam = c * la.float()
    L = lam * rf
    av = torch.exp(L)
    e2 = torch.exp(2.0 * L)
    beta = torch.sqrt(torch.clamp(1.0 - e2, min=0.0))
    bv = beta * (if_ * xf)

    def maps(ts):
        A, Bm = torch.ones(B, C), torch.zeros(B, C)
        for t in ts:
            A, Bm = A * av[:, t], av[:, t] * Bm + bv[:, t]
        return A, Bm

    h = h0.float() if h0 is not None else torch.zeros(B, C)
    entering = []
    for ci in range(nc):
        entering.append(h)
        ms = [maps(range(ci * T + w * sub, ci * T + (w + 1) * sub))
              for w in range(W)]
        for A, Bm in ms[:-1]:
            h = A * h + Bm
        for t in range(ci * T + (W - 1) * sub, (ci + 1) * T):
            h = av[:, t] * h + bv[:, t]
    dx, dga, dgi = (torch.zeros(B, nc * T, C) for _ in range(3))
    acc = torch.zeros(W, B, C)
    carry = ds.float() if ds is not None else torch.zeros(B, C)
    for ci in range(nc - 1, -1, -1):
        steps = [range(ci * T + w * sub, ci * T + (w + 1) * sub)
                 for w in range(W)]
        ms = [maps(ts) for ts in steps]
        rms = []
        for ts in steps:
            Ar, Br = torch.ones(B, C), torch.zeros(B, C)
            for t in reversed(ts):
                Ar, Br = Ar * av[:, t], av[:, t] * (dhf[:, t] + Br)
            rms.append((Ar, Br))
        out = None
        for w in range(W):
            h = entering[ci]
            for A, Bm in ms[:w]:
                h = A * h + Bm
            hp = {}
            for t in steps[w]:
                hp[t], h = h, av[:, t] * h + bv[:, t]
            cr = carry
            for Ar, Br in reversed(rms[w + 1:]):
                cr = Ar * cr + Br
            for t in reversed(steps[w]):
                g = dhf[:, t] + cr
                u = 1.0 - e2[:, t]
                db = torch.where(u > 0, -e2[:, t] / torch.where(
                    u > 0, beta[:, t], 1.0), 0.0)
                dL = g * (av[:, t] * hp[t] + db * (if_[:, t] * xf[:, t]))
                dx[:, t] = g * beta[:, t] * if_[:, t]
                dgi[:, t] = g * beta[:, t] * xf[:, t]
                dga[:, t] = lam * dL
                acc[w] += rf[:, t] * dL
                cr = av[:, t] * g
            if w == 0:
                out = cr
        carry = out
    dla = c * acc.sum(0).sum(0)
    return (dx[:, :S], dga[:, :S], dgi[:, :S], dla,
            carry if h0 is not None else None)


@pytest.mark.parametrize("case", [
    (2, 200, 40, True, True, 1.0, 1.0),     # four chunks, ragged S and C
    (1, 64, 32, False, False, 1.0, 1.0),    # one whole chunk
    (2, 130, 8, True, True, 100.0, 1.0),    # strong decay
], ids=str)
def test_chunked_composition_matches_the_plain_backward(case):
    """The kernel's chunks, warps and map compositions give the plain
    backward's gradients within 1e-5 relative L2 in float32."""
    arrays = _inputs(case, 500 + case[1])
    t = [None if a is None else torch.from_numpy(a) for a in arrays]
    got = _bwd_by_chunks(*t)
    want = rb.rglru_bwd_plain(*t[:6], initial_state=t[6])
    for name, g, w in zip(GRADS, got, want):
        if w is None:
            assert g is None
            continue
        assert _rel_l2(g.numpy(), w.numpy()) <= 1e-5, name


def test_geometry_mirrors_the_kernel_source():
    """CHUNK, TILE, WARPS and STAGES equal the constants of
    ``csrc/rglru_scan_bwd.cu`` (CHUNK, TILE and WARPS also the forward's
    in ``csrc/rglru_scan.cu``, whose entering states the backward reads),
    and the source uses no atomic operation: two launches give the same
    bits."""
    src = (_build.CSRC / "rglru_scan_bwd.cu").read_text()
    fwd = (_build.CSRC / "rglru_scan.cu").read_text()

    def const(name, text=src):
        return int(re.search(rf"constexpr int {name} = (\d+);", text)[1])

    assert (const("T"), const("TILE"), const("WARPS"), const("STAGES")) == \
        (rb.CHUNK, rb.TILE, rb.WARPS, rb.STAGES)
    assert (const("T", fwd), const("TILE", fwd), const("WARPS", fwd)) == \
        (rb.CHUNK, rb.TILE, rb.WARPS)
    assert not re.search(r"\batomic[A-Z]\w*\(|\batom\.|\bred\.", src)


def test_wrapper_refuses_cpu_tensors():
    arrays = _inputs((1, 8, 4, False, False, 1.0, 1.0), 41)
    x, ga, gi, la, dh, _, _ = (None if a is None else torch.from_numpy(a)
                               for a in arrays)
    entering = torch.zeros((1, 1, 4))
    with pytest.raises(ValueError, match="CUDA"):
        rb.rglru_bwd_cuda(x.bfloat16(), ga, gi, la, dh.bfloat16(),
                          entering=entering)
    assert rb.rglru_bwd_cuda.launches == 0


def test_reduced_recurrentgemma_remat_reruns_the_scan():
    """Reduced recurrentgemma-2b on the CPU: with each layer recomputed in
    the backward (remat) the RG-LRU scan runs again inside RGLRUScan and
    every stacked gradient equals the one without remat; the recurrence's
    ``a_param`` (log_a = -softplus(a_param)) receives one."""
    from repro_torch.configs import get_arch
    from repro_torch.models import lm
    from repro_torch.tree import leaves_with_path

    cfg = get_arch("recurrentgemma-2b").reduced()
    params = lm.init(cfg, seed=0, device="cpu", dtype=torch.float32,
                     stacked=True)
    named = [(p, t.requires_grad_()) for p, t in leaves_with_path(params)]
    rng = np.random.default_rng(51)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (2, 16))).long()}

    def grads(remat):
        total, _ = lm.loss_fn(cfg, params, batch, remat=remat,
                              dtype=torch.float32)
        return torch.autograd.grad(total, [t for _, t in named])

    plain, again = grads(False), grads(True)
    a_params = [g for (p, _), g in zip(named, plain) if "a_param" in p]
    assert a_params and all(g.abs().sum() > 0 for g in a_params)
    for (path, _), g, r in zip(named, plain, again):
        torch.testing.assert_close(r, g, rtol=1e-6, atol=1e-7, msg=path)
