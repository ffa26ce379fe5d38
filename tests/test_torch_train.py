"""The port's training path against the JAX package's, on the CPU.

Inputs are numpy arrays from ``default_rng``; weights come from the JAX
package's ``lm.init`` on reduced configs, flattened as its checkpointer
flattens them and loaded through ``params_from_numpy(..., dtype=float32,
stacked=True)``, the fp32 master weights training takes.  Covered: the
flash backward (plain formula and the autograd function) against
``jax.vjp`` of the reference's ``custom_vjp``; the loss and every stacked
gradient leaf against ``jax.value_and_grad`` of ``repro.models.lm.
loss_fn``; the vocab-chunked loss; AdamW; one train step at one and two
microbatches; the data pipeline; checkpoints written by either package and
read by the other; the train job under the lane executor; and the CLI.

Tolerances: float32 1e-4 (both packages do the same float32 arithmetic in
another order, ~1e-6 relative; a wrong mask, scale, cast or decay moves a
gradient by far more), losses 1e-5 relative (measured ~2e-7), AdamW
1e-6; bf16 as stated where used.
"""

import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.checkpoint.checkpointer import _flatten
from repro.configs import get_arch
from repro.configs.shapes import InputShape
from repro.data import pipeline as jdata
from repro.kernels import ops as jops
from repro.launch.steps import build_train_step as j_build_train_step
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro_torch import tree
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import get_arch as t_get_arch
from repro_torch.configs.shapes import InputShape as TInputShape
from repro_torch.core.executor import LaneExecutor
from repro_torch.core.jobs import make_train_job
from repro_torch.core.policies import make_policy
from repro_torch.data import pipeline as data
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd_plain
from repro_torch.launch import train
from repro_torch.launch.steps import build_train_step
from repro_torch.models import lm
from repro_torch.models.bridge import params_from_numpy
from repro_torch.optim import adamw

F32_TOL = 1e-4
LOSS_TOL = 1e-5
ADAMW_TOL = 1e-6
# bf16: each framework rounds the products' outputs, activations and
# residual adds to bf16 at its own places (8 bits of mantissa, ~4e-3 per
# rounding); through two layers, the loss and back, a gradient leaf moves
# by up to ~1.3e-2 relative L2 (measured); the bound is the models' 3e-2.
BF16_REL_L2 = 3e-2
BF16_LOSS_TOL = 1e-3
B, S = 2, 16


def _np(t) -> np.ndarray:
    return t.detach().float().numpy() if torch.is_tensor(t) \
        else np.asarray(t, np.float32)


def _rel_l2(got, want) -> float:
    got, want = _np(got), _np(want)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _key(path: str) -> str:
    return path.replace("/", "_")


def _trainable(cfg, flat):
    params = params_from_numpy(cfg, flat, device="cpu", dtype=torch.float32,
                               stacked=True)
    for p in tree.leaves(params):
        p.requires_grad_()
    return params


# ----------------------------------------------------------- flash backward
FLASH = [
    # (B, Sq, Sk, H, KV, D, mask_kind, window, q_offset)
    (2, 13, 13, 4, 2, 8, "causal", 0, 0),         # G 2, Sk % chunk != 0
    (1, 11, 23, 6, 2, 16, "causal", 0, 12),       # q_offset, G 3
    (2, 12, 20, 4, 1, 8, "window", 4, 8),         # window with q_offset
    (1, 9, 14, 2, 2, 8, "none", 0, 0),            # no mask, Sq != Sk, G 1
    (1, 8, 8, 2, 1, 8, "window", 2, 20),          # rows that see no key
]


@pytest.mark.parametrize("route", ["plain", "autograd"])
@pytest.mark.parametrize("case", FLASH, ids=str)
def test_flash_backward_matches_jax_vjp(case, route):
    Bq, Sq, Sk, H, KV, D, kind, window, off = case
    rng = np.random.default_rng(FLASH.index(case))
    q, k, v = (rng.standard_normal(s, dtype=np.float32)
               for s in ((Bq, Sq, H, D), (Bq, Sk, KV, D), (Bq, Sk, KV, D)))
    g = rng.standard_normal((Bq, Sq, H, D), dtype=np.float32)

    def fn(q, k, v):
        return jops.flash_attention(q, k, v, mask_kind=kind, window=window,
                                    q_offset=off, kv_chunk=5, backend="xla")

    _, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(g))
    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    kw = dict(mask_kind=kind, window=window, q_offset=off)
    if route == "plain":
        out, lse = flash_attention_plain(tq, tk, tv, return_lse=True, **kw)
        got = flash_attention_bwd_plain(tq, tk, tv, out, tg, lse, **kw)
    else:
        leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
        out = ops.flash_attention(*leaves, **kw)
        out.backward(tg)
        got = [t.grad for t in leaves]
    for name, w, gt in zip(("dq", "dk", "dv"), want, got):
        assert gt.shape == w.shape, name
        np.testing.assert_allclose(_np(gt), np.asarray(w), rtol=F32_TOL,
                                   atol=F32_TOL, err_msg=name)


def test_flash_rows_that_see_no_key_get_the_reference_lse_and_no_gradient():
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
               for s in ((1, 8, 2, 8), (1, 8, 1, 8), (1, 8, 1, 8)))
    kw = dict(mask_kind="window", window=2, q_offset=20)
    out, lse = flash_attention_plain(q, k, v, return_lse=True, **kw)
    assert torch.all(lse == -1e30) and not out.any()
    dq, dk, dv = flash_attention_bwd_plain(q, k, v, out, torch.ones_like(out),
                                           lse, **kw)
    assert not (dq.any() or dk.any() or dv.any())


def test_flash_without_grad_takes_the_serving_call():
    """No input requires grad: the op returns a plain tensor (no autograd
    history), the serving path's call."""
    q = torch.zeros((1, 4, 2, 8))
    assert ops.flash_attention(q, q[:, :, :1], q[:, :, :1]).grad_fn is None
    q.requires_grad_()
    with torch.no_grad():
        assert ops.flash_attention(q, q[:, :, :1].detach(),
                                   q[:, :, :1].detach()).grad_fn is None
    assert ops.flash_attention(q, q[:, :, :1].detach(),
                               q[:, :, :1].detach()).grad_fn is not None


# ------------------------------------------------------ loss and gradients
def _loss_case(arch, seed=0):
    cfg, tcfg = get_arch(arch).reduced(), t_get_arch(arch).reduced()
    params = jlm.init(cfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return cfg, tcfg, params, _flatten(params), tokens


def _jax_loss_and_grads(cfg, params, tokens, dtype):
    def f(p):
        return jlm.loss_fn(cfg, p, {"tokens": jnp.asarray(tokens)},
                           dtype=dtype)
    (total, metrics), grads = jax.value_and_grad(f, has_aux=True)(params)
    return total, metrics, _flatten(grads)


def _port_loss_and_grads(tcfg, flat, tokens, dtype):
    params = _trainable(tcfg, flat)
    total, metrics = lm.loss_fn(tcfg, params,
                                {"tokens": torch.from_numpy(tokens).long()},
                                dtype=dtype)
    total.backward()
    return total, metrics, params


TRAINED = ["yi-6b", "minicpm3-4b", "deepseek-v2-lite-16b", "mamba2-2.7b",
           "recurrentgemma-2b"]


@pytest.mark.parametrize("arch", TRAINED)
def test_loss_and_every_stacked_gradient_match_jax_float32(arch):
    """Every stacked leaf (the autograd leaves) receives the reference's
    gradient: a per-layer view taken before ``requires_grad_`` would leave
    its layer's gradient at None.  deepseek's MoE aux loss is in total."""
    cfg, tcfg, params, flat, tokens = _loss_case(arch)
    jt, jm, jg = _jax_loss_and_grads(cfg, params, tokens, jnp.float32)
    tt, tm, tparams = _port_loss_and_grads(tcfg, flat, tokens, torch.float32)
    assert abs(float(tt.detach()) - float(jt)) <= LOSS_TOL * abs(float(jt))
    for name in ("nll", "aux", "z"):
        np.testing.assert_allclose(float(tm[name].detach()), float(jm[name]),
                                   rtol=LOSS_TOL, atol=1e-7, err_msg=name)
    if cfg.moe is not None:
        assert float(tm["aux"].detach()) > 0.1
    paths = [p for p, _ in tree.leaves_with_path(tparams)]
    assert sorted(_key(p) for p in paths) == sorted(jg)
    for path, leaf in tree.leaves_with_path(tparams):
        assert leaf.grad is not None, path
        assert _rel_l2(leaf.grad, jg[_key(path)]) <= F32_TOL, path


def test_yi_loss_and_gradients_match_jax_bfloat16():
    cfg, tcfg, params, flat, tokens = _loss_case("yi-6b")
    jt, _, jg = _jax_loss_and_grads(cfg, params, tokens, jnp.bfloat16)
    tt, _, tparams = _port_loss_and_grads(tcfg, flat, tokens, torch.bfloat16)
    assert abs(float(tt.detach()) - float(jt)) \
        <= BF16_LOSS_TOL * abs(float(jt))
    for path, leaf in tree.leaves_with_path(tparams):
        assert _rel_l2(leaf.grad, jg[_key(path)]) <= BF16_REL_L2, path


def test_streamed_vocab_chunks_match_the_reference_loss(monkeypatch):
    """Chunks of 128 over the 512-column head (the reference's own loss
    takes the whole vocabulary in one chunk at this size): same loss and
    gradients."""
    import functools

    monkeypatch.setattr(lm, "_chunked_nll",
                        functools.partial(lm._chunked_nll, chunk=128))
    cfg, tcfg, params, flat, tokens = _loss_case("yi-6b")
    jt, _, jg = _jax_loss_and_grads(cfg, params, tokens, jnp.float32)
    tt, _, tparams = _port_loss_and_grads(tcfg, flat, tokens, torch.float32)
    assert abs(float(tt.detach()) - float(jt)) <= LOSS_TOL * abs(float(jt))
    for path, leaf in tree.leaves_with_path(tparams):
        assert _rel_l2(leaf.grad, jg[_key(path)]) <= F32_TOL, path


def _nll_inputs(transpose):
    rng = np.random.default_rng(21)
    x = rng.standard_normal((2, 5, 16), dtype=np.float32)
    table = rng.standard_normal((512, 16) if transpose else (16, 512),
                                dtype=np.float32)
    targets = rng.integers(0, 512, (2, 5)).astype(np.int32)
    return x, table, targets


@pytest.mark.parametrize("transpose", [False, True], ids=["head", "tied"])
@pytest.mark.parametrize("vocab,chunk", [(512, 128), (400, 128), (512, 200),
                                         (400, 200)])
def test_chunked_nll_matches_the_reference_where_it_is_exact(transpose,
                                                             vocab, chunk):
    """Columns >= vocab are masked (vocab 400 of 512).  Where ``chunk``
    divides V the reference streams correctly and both agree chunk for
    chunk; where it does not, the port is held to the reference taking
    the whole vocabulary in one chunk."""
    x, table, targets = _nll_inputs(transpose)
    ref_chunk = chunk if 512 % chunk == 0 else 512
    want = jlm._chunked_nll(jnp.asarray(x), jnp.asarray(table), transpose,
                            jnp.asarray(targets), vocab, chunk=ref_chunk,
                            dtype=jnp.float32)
    got = lm._chunked_nll(torch.from_numpy(x), torch.from_numpy(table),
                          transpose, torch.from_numpy(targets).long(), vocab,
                          chunk=chunk, dtype=torch.float32)
    for w, g in zip(want, got):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=F32_TOL,
                                   atol=F32_TOL)


def test_reference_chunked_nll_departs_where_the_chunk_does_not_divide():
    """Why the port cuts its last chunk at V: the reference's
    ``dynamic_slice`` moves a last chunk that would run past V back inside
    it, while its column labels stay where they were, so with chunk 200
    of 512 its lse counts columns 312-399 twice and misses 400-511 (yi-6b
    at full width: chunk 8192 of 64000)."""
    x, table, targets = _nll_inputs(False)
    args = (jnp.asarray(x), jnp.asarray(table), False, jnp.asarray(targets),
            512)
    _, exact = jlm._chunked_nll(*args, chunk=512, dtype=jnp.float32)
    _, streamed = jlm._chunked_nll(*args, chunk=200, dtype=jnp.float32)
    assert float(jnp.abs(streamed - exact).max()) > 1e3 * F32_TOL


# ------------------------------------------------------------------- AdamW
def _grads_like(flat, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (scale * rng.standard_normal(v.shape)).astype(np.float32)
            for k, v in flat.items()}


def _unflat_jax(template, flat):
    paths = jax.tree_util.tree_flatten_with_path(template)[0]
    keys = [_key("/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                          for p in path)) for path, _ in paths]
    return jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(template),
        [jnp.asarray(flat[k]) for k in keys])


def _unflat_port(tcfg, flat):
    return params_from_numpy(tcfg, flat, device="cpu", dtype=torch.float32,
                             stacked=True)


@pytest.mark.parametrize("clip", [1.0, 0.0, 1e3], ids=["clip", "no-clip",
                                                        "loose-clip"])
def test_adamw_update_matches_the_reference(clip):
    cfg, tcfg, params, flat, _ = _loss_case("yi-6b")
    opt_cfg = jadamw.OptConfig(lr=1e-2, warmup_steps=1, clip_norm=clip)
    t_opt_cfg = adamw.OptConfig(lr=1e-2, warmup_steps=1, clip_norm=clip)
    jp, js = params, jadamw.init(params)
    tp = _unflat_port(tcfg, flat)
    ts = adamw.init(tp)
    for i in range(2):              # the second step sees non-zero m, v
        gflat = _grads_like(flat, i, scale=0.3)
        jp, js, jstats = jadamw.update(_unflat_jax(params, gflat), js, jp,
                                       opt_cfg)
        tp, ts, tstats = adamw.update(_unflat_port(tcfg, gflat), ts, tp,
                                      t_opt_cfg)
        for name in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tstats[name]),
                                       float(jstats[name]), rtol=ADAMW_TOL)
    assert ts["step"].dtype == torch.int32 and int(ts["step"]) == 2
    assert int(js["step"]) == 2
    for got, want in ((tp, jp), (ts["m"], js["m"]), (ts["v"], js["v"])):
        wflat = _flatten(want)
        for path, leaf in tree.leaves_with_path(got):
            np.testing.assert_allclose(_np(leaf), wflat[_key(path)],
                                       rtol=ADAMW_TOL, atol=ADAMW_TOL,
                                       err_msg=path)


def test_adamw_reports_the_norm_before_clipping():
    _, tcfg, _, flat, _ = _loss_case("yi-6b")
    gflat = _grads_like(flat, 5, scale=10.0)
    grads = _unflat_port(tcfg, gflat)
    want = np.sqrt(sum(float(np.sum(np.square(g.astype(np.float64))))
                       for g in gflat.values()))
    tp = _unflat_port(tcfg, flat)
    cfg = adamw.OptConfig(clip_norm=1.0)
    _, state, stats = adamw.update(grads, adamw.init(tp), tp, cfg)
    assert float(stats["grad_norm"]) == pytest.approx(want, rel=1e-5)
    # m after one step is (1 - beta1) times the clipped gradient
    m = torch.cat([t.flatten() for t in tree.leaves(state["m"])])
    assert float(m.norm()) == pytest.approx((1 - cfg.beta1) * 1.0, rel=1e-4)


def test_adamw_decays_stacked_leaves_by_their_stacked_rank():
    """With zero gradients only the decay moves a weight: a stage's norm
    scale ([L, d] stacked) decays, as in the reference; final_norm ([d])
    does not."""
    _, tcfg, _, flat, _ = _loss_case("yi-6b")
    tp = _unflat_port(tcfg, flat)
    zeros = tree.tree_map(torch.zeros_like, tp)
    cfg = adamw.OptConfig(lr=0.5, warmup_steps=1, weight_decay=0.1)
    adamw.update(zeros, adamw.init(tp), tp, cfg)
    np.testing.assert_array_equal(_np(tp["final_norm"]["scale"]),
                                  flat["final_norm_scale"])
    np.testing.assert_allclose(_np(tp["stage0"]["u0"]["norm1"]["scale"]),
                               flat["stage0_u0_norm1_scale"] * (1 - 0.05),
                               rtol=1e-6)


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_schedule_lr_matches_the_reference(schedule):
    for warmup, total in ((100, 10_000), (0, 50), (7, 7)):
        jcfg = jadamw.OptConfig(lr=3e-4, warmup_steps=warmup,
                                total_steps=total, schedule=schedule)
        tcfg = adamw.OptConfig(lr=3e-4, warmup_steps=warmup,
                               total_steps=total, schedule=schedule)
        for step in (0, 1, 6, 7, 50, 99, 100, 101, 5000, 10_000, 20_000):
            want = float(jadamw.schedule_lr(
                jcfg, jnp.asarray(step, jnp.int32)))
            got = float(adamw.schedule_lr(
                tcfg, torch.tensor(step, dtype=torch.int32)))
            assert got == pytest.approx(want, rel=ADAMW_TOL, abs=1e-12), step


# --------------------------------------------------------------- train step
@pytest.mark.parametrize("M", [1, 2])
def test_train_step_matches_the_reference(M, monkeypatch):
    """Both steps with their losses in float32 (each step's own default is
    bf16 compute, whose roundings would swamp a 1e-4 comparison of
    AdamW's sign-like first update)."""
    import functools

    from repro.launch import steps as jsteps
    from repro_torch.launch import steps as tsteps

    monkeypatch.setattr(jsteps.lm, "loss_fn", functools.partial(
        jlm.loss_fn, dtype=jnp.float32))
    monkeypatch.setattr(tsteps.lm, "loss_fn", functools.partial(
        lm.loss_fn, dtype=torch.float32))
    cfg, tcfg, params, flat, _ = _loss_case("yi-6b")
    shape = InputShape("t", S, 4, "train")
    opt = jadamw.OptConfig(lr=1e-3, warmup_steps=1)
    bundle = j_build_train_step(cfg, shape, mesh=None, opt_cfg=opt,
                                remat=False, microbatches=M)
    tokens = np.random.default_rng(8).integers(0, cfg.vocab_size,
                                               (4, S)).astype(np.int32)
    jp, js, jm = bundle.fn(params, jadamw.init(params),
                           {"tokens": jnp.asarray(tokens)})
    tbundle = build_train_step(tcfg, TInputShape("t", S, 4, "train"),
                               opt_cfg=adamw.OptConfig(lr=1e-3,
                                                       warmup_steps=1),
                               remat=False, microbatches=M)
    tp = _trainable(tcfg, flat)
    tp, ts, tm = tbundle.fn(tp, adamw.init(tp),
                            {"tokens": torch.from_numpy(tokens).long()})
    assert sorted(tm) == sorted(jm) == ["aux", "grad_norm", "lr", "nll", "z"]
    for name in jm:
        np.testing.assert_allclose(float(tm[name].detach()), float(jm[name]),
                                   rtol=LOSS_TOL, atol=1e-7, err_msg=name)
    wflat = _flatten(jp)
    for path, leaf in tree.leaves_with_path(tp):
        assert leaf.requires_grad, path
        np.testing.assert_allclose(_np(leaf), wflat[_key(path)],
                                   rtol=F32_TOL, atol=F32_TOL, err_msg=path)


def test_train_step_refuses_a_mesh():
    with pytest.raises(TypeError, match="DeviceMesh"):
        build_train_step(t_get_arch("yi-6b").reduced(),
                         TInputShape("t", S, 4, "train"), mesh=object())


# --------------------------------------------------------------------- data
def test_tokens_transform_matches_the_reference_on_shared_uniforms():
    key = jax.random.PRNGKey(4)
    u = jax.random.uniform(key, (64, 128), jnp.float32, 1e-6, 1.0)
    for vocab, alpha in ((512, 1.1), (64000, 1.1), (1000, 1.5)):
        want = np.asarray(jdata._tokens(key, (64, 128), vocab, alpha))
        got = data._tokens(torch.from_numpy(np.array(u)), vocab, alpha)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want)


def test_batches_are_deterministic_seekable_and_shaped_by_batch_spec():
    cfg = t_get_arch("yi-6b").reduced()
    shape = TInputShape("t", 32, 3, "train")
    dcfg = data.DataConfig(seed=5)
    first = data.batch_for_step(cfg, shape, 4, dcfg)
    spec = data.batch_spec(cfg, shape)
    assert sorted(first) == sorted(spec)
    for name, (shp, dtype) in spec.items():
        assert tuple(first[name].shape) == shp and first[name].dtype == dtype
    assert torch.equal(first["tokens"],
                       data.batch_for_step(cfg, shape, 4, dcfg)["tokens"])
    assert not torch.equal(first["tokens"],
                           data.batch_for_step(cfg, shape, 5, dcfg)["tokens"])
    assert not torch.equal(first["tokens"], data.batch_for_step(
        cfg, shape, 4, data.DataConfig(seed=6))["tokens"])
    it = data.iterate(cfg, shape, start_step=3, data_cfg=dcfg)
    for step in (3, 4, 5):
        assert torch.equal(next(it)["tokens"],
                           data.batch_for_step(cfg, shape, step,
                                               dcfg)["tokens"])
    it.close()
    toks = first["tokens"]
    assert int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size


def test_batch_spec_has_the_references_entries():
    for arch in ("yi-6b", "pixtral-12b", "whisper-large-v3"):
        cfg, tcfg = get_arch(arch).reduced(), t_get_arch(arch).reduced()
        shape = InputShape("t", 48, 2, "train")
        want = jdata.batch_spec(cfg, shape)
        got = data.batch_spec(tcfg, TInputShape("t", 48, 2, "train"))
        assert sorted(got) == sorted(want)
        for name in want:
            assert got[name][0] == tuple(want[name].shape), (arch, name)


# -------------------------------------------------------------- checkpoints
def _port_state(tcfg, flat):
    params = _trainable(tcfg, flat)
    opt = adamw.init(params)
    with torch.no_grad():
        for i, m in enumerate(tree.leaves(opt["m"])):
            m.fill_(0.5 + i)
    opt["step"] = torch.tensor(7, dtype=torch.int32)
    return {"params": params, "opt": opt}


def test_a_port_checkpoint_restores_into_the_reference(tmp_path):
    cfg, tcfg, params, flat, _ = _loss_case("yi-6b")
    state = _port_state(tcfg, flat)
    ck = Checkpointer(tmp_path, async_save=False)
    ck.save(7, state, {"arch": "yi-6b"})
    template = {"params": params, "opt": jadamw.init(params)}
    step, restored, meta = JCheckpointer(tmp_path, async_save=False).restore(
        template)
    assert step == 7 and meta["arch"] == "yi-6b"
    got = _flatten(restored)
    want = {_key(p): _np(t) for p, t in tree.leaves_with_path(state)}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k], np.float32),
                                      want[k], err_msg=k)


def test_a_reference_checkpoint_restores_into_the_port(tmp_path):
    cfg, tcfg, params, flat, _ = _loss_case("yi-6b")
    jstate = {"params": params, "opt": jadamw.init(params)}
    jstate["opt"]["m"] = jax.tree.map(lambda p: p + 1.5, params)
    JCheckpointer(tmp_path, async_save=False).save(3, jstate, {"x": 1})
    template = _port_state(tcfg, flat)
    step, restored, meta = Checkpointer(tmp_path).restore(template)
    assert step == 3 and meta["x"] == 1
    want = _flatten(jstate)
    for path, leaf in tree.leaves_with_path(restored):
        tmpl = dict(tree.leaves_with_path(template))[path]
        assert leaf.dtype == tmpl.dtype
        assert leaf.requires_grad == tmpl.requires_grad
        np.testing.assert_array_equal(_np(leaf), want[_key(path)],
                                      err_msg=path)


def test_checkpointer_saves_async_keeps_the_last_and_checks_shapes(tmp_path):
    _, tcfg, _, flat, _ = _loss_case("yi-6b")
    state = _port_state(tcfg, flat)
    ck = Checkpointer(tmp_path, keep=2)
    for step in (1, 2, 3):
        ck.save(step, state)
    ck.wait()
    assert ck.all_steps() == [2, 3] and ck.latest_step() == 3
    assert not list(tmp_path.glob(".tmp_*"))
    bad = _port_state(tcfg, flat)
    bad["params"]["embed"]["table"] = torch.zeros(3, 3)
    with pytest.raises(ValueError, match="shape mismatch"):
        ck.restore(bad)
    missing = _port_state(tcfg, flat)
    missing["extra"] = torch.zeros(2)
    with pytest.raises(KeyError, match="extra"):
        ck.restore(missing)
    with pytest.raises(FileNotFoundError):
        Checkpointer(tmp_path / "empty").restore(state)


def _cli(*extra):
    return ["--device", "cpu", "--reduced", "--arch", "yi-6b", "--batch",
            "2", "--seq", "16", "--log-every", "1", *extra]


def test_resume_continues_with_the_uninterrupted_losses(tmp_path, capsys):
    whole = train.main(_cli("--steps", "4", "--checkpoint-dir",
                            str(tmp_path / "a"), "--checkpoint-every", "2"))
    # resume from the step-2 checkpoint alone
    (tmp_path / "b").mkdir()
    shutil.copytree(tmp_path / "a" / "step_0000000002",
                    tmp_path / "b" / "step_0000000002")
    resumed = train.main(_cli("--steps", "4", "--checkpoint-dir",
                              str(tmp_path / "b"), "--resume"))
    assert "resumed from step 2" in capsys.readouterr().out
    assert [r["step"] for r in resumed["steps"]] == [2, 3]
    for a, b in zip(whole["steps"][2:], resumed["steps"]):
        for name in ("nll", "aux", "z", "grad_norm", "lr"):
            assert a[name] == b[name], (a, b)
    assert Checkpointer(tmp_path / "b").latest_step() == 4


def test_no_final_checkpoint_writes_only_the_periodic_ones(tmp_path):
    # --checkpoint-every 2 of 4 steps: step 2's state alone, since the
    # last step's save is the final one that the flag leaves out
    args = _cli("--steps", "4", "--checkpoint-dir", str(tmp_path),
                "--no-final-checkpoint")
    whole = train.main([*args, "--checkpoint-every", "2"])
    assert Checkpointer(tmp_path).all_steps() == [2]
    resumed = train.main([*args, "--resume"])
    assert Checkpointer(tmp_path).all_steps() == [2]
    assert [r["step"] for r in resumed["steps"]] == [2, 3]
    for a, b in zip(whole["steps"][2:], resumed["steps"]):
        for name in ("nll", "aux", "z", "grad_norm", "lr"):
            assert a[name] == b[name], (a, b)


# ------------------------------------------------------- train job and CLI
def test_train_jobs_finish_under_the_lane_executor_and_resume(tmp_path):
    cfg = t_get_arch("yi-6b").reduced()
    ck = Checkpointer(tmp_path, async_save=False)
    jobs = [make_train_job(cfg, "a", blocks=4, batch=2, seq=16, device="cpu",
                           checkpointer=ck, checkpoint_every=2),
            make_train_job(cfg, "b", blocks=2, batch=2, seq=16, seed=1,
                           arrival=0.01, device="cpu")]
    res = LaneExecutor(jobs, make_policy("srtf"), n_lanes=2).run()
    assert sorted(r.blocks for r in res.values()) == [2, 4]
    assert ck.all_steps() == [2, 4]
    again = make_train_job(cfg, "a", blocks=6, batch=2, seq=16, device="cpu",
                           checkpointer=ck, resume=True)
    assert again.num_blocks == 2


def test_train_job_warmup_leaves_the_weights_alone(tmp_path):
    """A warmed job's first block ends where an unwarmed one's does."""
    cfg = t_get_arch("yi-6b").reduced()
    states = []
    for warm in (True, False):
        ck = Checkpointer(tmp_path / str(warm), async_save=False)
        job = make_train_job(cfg, "a", blocks=1, batch=2, seq=16,
                             device="cpu", checkpointer=ck,
                             checkpoint_every=1)
        if warm:
            job.warmup_fn()
        job.make_block_fn(1)()
        states.append(np.load(tmp_path / str(warm) / "step_0000000001" /
                              "arrays.npz"))
    for k in states[0].files:
        np.testing.assert_array_equal(states[0][k], states[1][k], err_msg=k)


def test_train_cli_single_and_multi_job_on_cpu(capsys):
    single = train.main(_cli("--steps", "3"))
    assert [r["step"] for r in single["steps"]] == [0, 1, 2]
    assert all(np.isfinite(r["nll"]) for r in single["steps"])
    assert single["predicted_s"] is not None
    assert single["peak_bytes"] is None
    multi = train.main(["--device", "cpu", "--reduced", "--jobs",
                        "yi-6b:3,yi-6b:1", "--batch", "2", "--seq", "16"])
    assert sorted(r.blocks for r in multi["results"].values()) == [1, 3]
    out = capsys.readouterr().out
    assert "[predictor]" in out and "[multi] policy=srtf" in out


def test_train_cli_cuts_depth_and_keeps_width():
    args = train.build_parser().parse_args(["--n-layers", "3"])
    cfg = train.arch_config(args, "yi-6b")
    full = t_get_arch("yi-6b")
    assert cfg.n_layers == 3
    assert dataclasses.replace(cfg, n_layers=full.n_layers) == full


def test_train_entry_points_refuse_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--reduced", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_train_job(t_get_arch("yi-6b").reduced(), "x", blocks=1)
