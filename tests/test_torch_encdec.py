"""whisper-large-v3 (the encoder and cross attention) and pixtral-12b (the
patch prefix) in the port against the JAX package, on the CPU.

Reduced configs: whisper-large-v3 (2 encoder layers over 32 frames, 2
decoder layers with cross attention, d 128, 4 heads of 32, layer norms
with biases, gelu MLPs with biases) and pixtral-12b (2 layers, 8 patch
embeddings in front of the text, 4 heads over 2 of 32).  Weights come from
the JAX package's ``lm.init(PRNGKey(0))``, flattened as its checkpointer
flattens them and loaded through ``params_from_numpy``; tokens, frames and
patches are numpy arrays from ``default_rng``.  Every comparison is in
float32 unless it says otherwise.

Tolerances (those of ``test_torch_model.py`` and ``test_torch_train.py``):
logits and caches within 1e-4 (both packages do the same float32
arithmetic in another order, ~1e-6; a wrong mask, position, bias or cache
slot moves logits by >1e-2); losses within 1e-5 relative; each stacked
gradient within 1e-4 relative L2.  The key biases' gradients in the
encoder's and cross attention's unmasked, rope-less attention (``bk``)
are zero in exact arithmetic (a bias added to every key shifts a query's
logits by one constant, which the softmax ignores), so both packages give
rounding noise there, ~1e-9 in norm: those leaves are held below 1e-6 in
norm on both sides instead.  (The decoder's rope rotates its key bias by
position, so its ``bk`` has a true gradient and the common bound.)
The serving job runs in bf16, its default: logits within 3e-2 relative L2
of the reference's on the same tokens (``test_torch_model.py``'s bf16
bound).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.checkpoint.checkpointer import _flatten
from repro.configs import get_arch
from repro.configs.shapes import InputShape
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro_torch import intra_op_threads, tree
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import get_arch as t_get_arch
from repro_torch.configs.shapes import InputShape as TInputShape
from repro_torch.core import jobs
from repro_torch.launch import serve, train
from repro_torch.launch import steps as tsteps
from repro_torch.models import lm
from repro_torch.models.bridge import params_from_numpy
from repro_torch.optim import adamw


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The module's CPU work on one intra-op thread: its small products
    would wake every thread, which under the suite's parallel workers
    makes them many times slower (the rule of ``README.md``'s "Tests on
    the CPU")."""
    with intra_op_threads(1):
        yield


F32_TOL = 1e-4
LOSS_TOL = 1e-5
BF16_REL_L2 = 3e-2
ZERO_GRAD_NORM = 1e-6
B, S, DECODE_STEPS = 2, 12, 3
ARCHS = ["whisper-large-v3", "pixtral-12b"]


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    """(cfg, tcfg, params, flat, inputs): the JAX package's weights and
    numpy inputs -- tokens [B, S], decode tokens [steps, B], and frames
    [B, F, d] (whisper) or patches [B, P, d] (pixtral)."""
    arch = request.param
    cfg, tcfg = get_arch(arch).reduced(), t_get_arch(arch).reduced()
    params = jlm.init(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(ARCHS.index(arch))
    inputs = {
        "tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
        "steps": rng.integers(0, cfg.vocab_size,
                              (DECODE_STEPS, B)).astype(np.int32)}
    if cfg.encoder is not None:
        inputs["frames"] = rng.standard_normal(
            (B, cfg.encoder.n_frames, cfg.d_model), dtype=np.float32)
    if cfg.n_patches:
        inputs["patches"] = rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model), dtype=np.float32)
    return cfg, tcfg, params, _flatten(params), inputs


def _extras(inputs, to):
    """The prefix keyword arguments of forward / prefill, through ``to``
    (jnp.asarray or torch.from_numpy)."""
    out = {}
    if "frames" in inputs:
        out["enc_frames"] = to(inputs["frames"])
    if "patches" in inputs:
        out["patches"] = to(inputs["patches"])
    return out


def _prefix(inputs) -> int:
    return inputs["patches"].shape[1] if "patches" in inputs else 0


def _np(t) -> np.ndarray:
    return t.detach().float().numpy() if torch.is_tensor(t) \
        else np.asarray(t, np.float32)


def _key(path: str) -> str:
    return path.replace("/", "_")


def _assert_tree_close(got, want, tol=F32_TOL, prefix=""):
    """The port's nested cache against the reference's, leaf by leaf."""
    assert sorted(got) == sorted(want), (prefix, sorted(got), sorted(want))
    for name, g in got.items():
        if isinstance(g, dict):
            _assert_tree_close(g, want[name], tol, f"{prefix}/{name}")
        else:
            np.testing.assert_allclose(_np(g), _np(want[name]), rtol=tol,
                                       atol=tol, err_msg=f"{prefix}/{name}")


# ------------------------------------------------------------- parameters
def test_every_leaf_has_the_reference_shape(case):
    cfg, tcfg, _, flat, _ = case
    shapes = lm.param_shapes(tcfg)
    assert sorted(_key(k) for k in shapes) == sorted(flat)
    for key, (shape, _) in shapes.items():
        assert flat[_key(key)].shape == shape, key
    tparams = lm.init(tcfg, seed=2, device="cpu", dtype=torch.float32)
    got = {_key(p): tuple(t.shape) for p, t in tree.leaves_with_path(
        params_from_numpy(tcfg, flat, device="cpu", stacked=True))}
    assert got == {k: v.shape for k, v in flat.items()}
    layers = tparams["stage0"]["u0"]
    assert len(layers) == tcfg.n_layers
    if cfg.encoder is not None:
        enc = tparams["encoder"]["layers"]
        assert len(enc) == cfg.encoder.n_layers
        assert tuple(enc[0]["mixer"]["bq"].shape) == \
            flat["encoder_layers_mixer_bq"].shape[1:]
        assert tuple(layers[0]["cross"]["wq"].shape) == \
            flat["stage0_u0_cross_wq"].shape[1:]
        assert layers[0]["norm_cross"]["bias"].dtype == torch.float32
    else:
        assert "encoder" not in tparams and "cross" not in layers[0]


# ------------------------------------------------------- forward and serving
@pytest.mark.parametrize("prefix", [True, False], ids=["prefix", "text"])
def test_forward_logits_match_jax(case, prefix):
    """With frames (whisper) or patches (pixtral), and without them: the
    cross layers skipped, or the text alone."""
    cfg, tcfg, params, flat, inputs = case
    extra = inputs if prefix else {}
    want, _, _ = jlm.forward(cfg, params, jnp.asarray(inputs["tokens"]),
                             dtype=jnp.float32,
                             **_extras(extra, jnp.asarray))
    tparams = params_from_numpy(tcfg, flat, device="cpu", dtype=torch.float32)
    got, aux = lm.forward(tcfg, tparams,
                          torch.from_numpy(inputs["tokens"]).long(),
                          dtype=torch.float32,
                          **_extras(extra, torch.from_numpy))
    assert got.shape == want.shape == (B, S + (_prefix(extra)),
                                       cfg.padded_vocab)
    assert float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)


@pytest.mark.parametrize("prefix", [True, False], ids=["prefix", "text"])
def test_prefill_and_decode_match_jax(case, prefix):
    """Prefill, then three decode steps: the logits of each and the caches
    after the prefill and after the last step, leaf by leaf (with frames,
    each cross layer's ``cross`` keys and values of the encoder's output;
    without them, no ``cross`` entry)."""
    cfg, tcfg, params, flat, inputs = case
    extra = inputs if prefix else {}
    n0 = S + _prefix(extra)
    max_seq = n0 + DECODE_STEPS + 5
    jl, jc = jlm.prefill(cfg, params, jnp.asarray(inputs["tokens"]),
                         max_seq=max_seq, dtype=jnp.float32,
                         **_extras(extra, jnp.asarray))
    tparams = params_from_numpy(tcfg, flat, device="cpu", dtype=torch.float32)
    tl, tc = lm.prefill(tcfg, tparams,
                        torch.from_numpy(inputs["tokens"]).long(),
                        max_seq=max_seq, dtype=torch.float32,
                        **_extras(extra, torch.from_numpy))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=F32_TOL,
                               atol=F32_TOL)
    _assert_tree_close(tc, jc)
    assert ("cross" in tc["stage0"]["u0"]) == ("frames" in extra)
    jlen = jnp.full((B,), n0, jnp.int32)
    tlen = torch.full((B,), n0, dtype=torch.int32)
    for tok in inputs["steps"]:
        jl, jc = jlm.decode_step(cfg, params, jnp.asarray(tok), jc, jlen,
                                 dtype=jnp.float32)
        tl, tc = lm.decode_step(tcfg, tparams, torch.from_numpy(tok).long(),
                                tc, tlen, dtype=torch.float32)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=F32_TOL,
                                   atol=F32_TOL)
        jlen, tlen = jlen + 1, tlen + 1
    _assert_tree_close(tc, jc)


def test_prefill_counts_the_patch_prefix_against_max_seq():
    cfg = t_get_arch("pixtral-12b").reduced()
    tparams = lm.init(cfg, device="cpu")
    tokens = torch.zeros((1, 4), dtype=torch.long)
    patches = torch.zeros((1, cfg.n_patches, cfg.d_model))
    with pytest.raises(ValueError, match="patch prefix"):
        lm.prefill(cfg, tparams, tokens, patches=patches,
                   max_seq=cfg.n_patches + 3)
    logits, caches = lm.prefill(cfg, tparams, tokens, patches=patches,
                                max_seq=cfg.n_patches + 4)
    assert logits.shape == (1, cfg.padded_vocab)
    assert caches["stage0"]["u0"]["k"].shape[2] == cfg.n_patches + 4


# ------------------------------------------------------ loss and gradients
@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_loss_and_every_stacked_gradient_match_jax(case, remat):
    """Every stacked leaf, the encoder's and the cross layers' included,
    receives the reference's gradient; the loss is on the token positions
    only.  ``remat`` recomputes every layer, the encoder's too."""
    cfg, tcfg, params, flat, inputs = case
    jbatch = {"tokens": jnp.asarray(inputs["tokens"])}
    tbatch = {"tokens": torch.from_numpy(inputs["tokens"]).long()}
    for name in ("frames", "patches"):
        if name in inputs:
            jbatch[name] = jnp.asarray(inputs[name])
            tbatch[name] = torch.from_numpy(inputs[name])

    def f(p):
        return jlm.loss_fn(cfg, p, jbatch, dtype=jnp.float32)

    (jt, jm), jg = jax.value_and_grad(f, has_aux=True)(params)
    jg = _flatten(jg)
    tparams = params_from_numpy(tcfg, flat, device="cpu", dtype=torch.float32,
                                stacked=True)
    for p in tree.leaves(tparams):
        p.requires_grad_()
    tt, tm = lm.loss_fn(tcfg, tparams, tbatch, remat=remat,
                        dtype=torch.float32)
    tt.backward()
    assert abs(float(tt.detach()) - float(jt)) <= LOSS_TOL * abs(float(jt))
    for name in ("nll", "z"):
        np.testing.assert_allclose(float(tm[name].detach()), float(jm[name]),
                                   rtol=LOSS_TOL, err_msg=name)
    paths = [p for p, _ in tree.leaves_with_path(tparams)]
    assert sorted(_key(p) for p in paths) == sorted(jg)
    if cfg.encoder is not None:
        assert any(p.startswith("encoder/") for p in paths)
    for path, leaf in tree.leaves_with_path(tparams):
        got, want = _np(leaf.grad), np.asarray(jg[_key(path)], np.float32)
        if path.endswith("/cross/bk") or path == "encoder/layers/mixer/bk":
            assert np.linalg.norm(got) <= ZERO_GRAD_NORM, path
            assert np.linalg.norm(want) <= ZERO_GRAD_NORM, path
            continue
        err = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
        assert err <= F32_TOL, (path, err)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_the_reference_with_prefixes(arch, monkeypatch):
    """One optimizer step over two microbatches of a batch with frames or
    patches (each cut in two along the batch, as both packages cut them):
    metrics and every updated leaf against the reference's step, both
    losses in float32."""
    monkeypatch.setattr(jsteps.lm, "loss_fn", functools.partial(
        jlm.loss_fn, dtype=jnp.float32))
    monkeypatch.setattr(tsteps.lm, "loss_fn", functools.partial(
        lm.loss_fn, dtype=torch.float32))
    cfg, tcfg = get_arch(arch).reduced(), t_get_arch(arch).reduced()
    params = jlm.init(cfg, jax.random.PRNGKey(3))
    flat = _flatten(params)
    rng = np.random.default_rng(30 + ARCHS.index(arch))
    seq = cfg.n_patches + S
    shape = InputShape("t", seq, 4, "train")
    batch = {name: (rng.integers(0, cfg.vocab_size, s).astype(np.int32)
                    if name == "tokens" else
                    rng.standard_normal(s, dtype=np.float32))
             for name, s in ((k, v.shape) for k, v in
                             jsteps.data_pipeline.batch_spec(cfg,
                                                             shape).items())}
    assert sorted(batch) == sorted(["tokens"] + (["frames"] if cfg.encoder
                                                 else ["patches"]))
    opt = jadamw.OptConfig(lr=1e-3, warmup_steps=1)
    bundle = jsteps.build_train_step(cfg, shape, mesh=None, opt_cfg=opt,
                                     remat=False, microbatches=2)
    jp, _, jm = bundle.fn(params, jadamw.init(params),
                          jax.tree.map(jnp.asarray, batch))
    tbundle = tsteps.build_train_step(
        tcfg, TInputShape("t", seq, 4, "train"),
        opt_cfg=adamw.OptConfig(lr=1e-3, warmup_steps=1), remat=False,
        microbatches=2)
    tp = params_from_numpy(tcfg, flat, device="cpu", dtype=torch.float32,
                           stacked=True)
    for p in tree.leaves(tp):
        p.requires_grad_()
    tbatch = {k: torch.from_numpy(v).long() if k == "tokens"
              else torch.from_numpy(v) for k, v in batch.items()}
    tp, _, tm = tbundle.fn(tp, adamw.init(tp), tbatch)
    for name in ("nll", "z", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[name].detach()), float(jm[name]),
                                   rtol=LOSS_TOL, atol=1e-7, err_msg=name)
    wflat = _flatten(jp)
    for path, leaf in tree.leaves_with_path(tp):
        np.testing.assert_allclose(_np(leaf), wflat[_key(path)],
                                   rtol=F32_TOL, atol=F32_TOL, err_msg=path)


# -------------------------------------------------------------- checkpoints
def test_whisper_train_state_round_trips_through_both_checkpointers(
        tmp_path):
    """The port's train state (the encoder's stacked leaves included)
    saved by the port, restored by the reference and by the port, every
    leaf bitwise equal."""
    cfg, tcfg = get_arch("whisper-large-v3").reduced(), \
        t_get_arch("whisper-large-v3").reduced()
    params = jlm.init(cfg, jax.random.PRNGKey(1))
    tparams = params_from_numpy(tcfg, _flatten(params), device="cpu",
                                dtype=torch.float32, stacked=True)
    for p in tree.leaves(tparams):
        p.requires_grad_()
    opt = adamw.init(tparams)
    rng = np.random.default_rng(5)
    with torch.no_grad():
        for m in tree.leaves(opt["m"]):
            m.copy_(torch.from_numpy(rng.standard_normal(
                tuple(m.shape), dtype=np.float32)))
    opt["step"] = torch.tensor(4, dtype=torch.int32)
    state = {"params": tparams, "opt": opt}
    Checkpointer(tmp_path, async_save=False).save(4, state, {"arch": "w"})
    want = {_key(p): _np(t) for p, t in tree.leaves_with_path(state)}
    assert any(k.startswith("params_encoder_layers_") for k in want)

    step, restored, meta = JCheckpointer(tmp_path, async_save=False).restore(
        {"params": params, "opt": jadamw.init(params)})
    assert step == 4 and meta["arch"] == "w"
    got = _flatten(restored)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k], np.float32),
                                      want[k], err_msg=k)

    template = {"params": params_from_numpy(
        tcfg, _flatten(params), device="cpu", dtype=torch.float32,
        stacked=True), "opt": adamw.init(tparams)}
    step, back, _ = Checkpointer(tmp_path).restore(template)
    assert step == 4
    for path, leaf in tree.leaves_with_path(back):
        np.testing.assert_array_equal(_np(leaf), want[_key(path)],
                                      err_msg=path)


# ---------------------------------------------------------------- entry points
def test_served_whisper_runs_its_decoder_alone_as_the_reference_does(
        monkeypatch):
    """The serve job (bf16, the reference's weights) passes no frames, as
    ``repro.core.jobs.make_serve_job`` passes none: its caches hold no
    cross entry, and its logits match the reference's prefill and decode
    steps without frames on the same tokens."""
    cfg, tcfg = get_arch("whisper-large-v3").reduced(), \
        t_get_arch("whisper-large-v3").reduced()
    params = jlm.init(cfg, jax.random.PRNGKey(4))
    flat = _flatten(params)
    monkeypatch.setattr(jobs.lm, "init", lambda c, seed, device: (
        params_from_numpy(c, flat, device=device)))
    seen = {"logits": [], "tokens": [], "caches": None}
    prefill, decode_step = lm.prefill, lm.decode_step

    def record_prefill(*args, **kwargs):
        logits, caches = prefill(*args, **kwargs)
        seen["logits"].append(logits)
        seen["caches"] = caches
        return logits, caches

    def record_decode(c, p, token, caches, lengths, **kwargs):
        seen["tokens"].append(token.clone())
        logits, caches = decode_step(c, p, token, caches, lengths, **kwargs)
        seen["logits"].append(logits)
        return logits, caches

    monkeypatch.setattr(jobs.lm, "prefill", record_prefill)
    monkeypatch.setattr(jobs.lm, "decode_step", record_decode)
    prompt = np.random.default_rng(9).integers(0, cfg.vocab_size, (B, S))
    job = jobs.make_serve_job(tcfg, "w", blocks=1, tokens_per_block=3,
                              batch=B, prompt_len=S, prompt=prompt,
                              device="cpu")
    job.make_block_fn(1)()
    assert "cross" not in seen["caches"]["stage0"]["u0"]
    max_seq = S + 1 * 3 + 8
    jl, jc = jlm.prefill(cfg, params, jnp.asarray(prompt, jnp.int32),
                         max_seq=max_seq)
    want = [jl]
    lengths = jnp.full((B,), S, jnp.int32)
    for tok in seen["tokens"]:
        jl, jc = jlm.decode_step(cfg, params, jnp.asarray(tok.numpy()), jc,
                                 lengths)
        want.append(jl)
        lengths = lengths + 1
    assert len(seen["logits"]) == len(want) == 4
    for g, w in zip(seen["logits"], want):
        g, w = _np(g), np.asarray(w, np.float32)
        rel = np.linalg.norm(g - w, axis=-1) / np.linalg.norm(w, axis=-1)
        assert rel.max() < BF16_REL_L2, rel


def test_serve_cli_serves_pixtral_beside_whisper_on_cpu(capsys):
    runs = serve.main(["--device", "cpu", "--reduced",
                       "--jobs", "pixtral-12b:2,whisper-large-v3:1",
                       "--policy", "srtf", "--compare-fifo",
                       "--tokens-per-block", "2", "--prompt-len", "8",
                       "--batch", "1", "--lanes", "2", "--stagger", "0"])
    assert sorted(runs) == ["fifo", "srtf"]
    for run in runs.values():
        assert sorted((r.key.split("#")[0], r.blocks, r.cancelled)
                      for r in run["results"]) == [
            ("pixtral-12b", 2, False), ("whisper-large-v3", 1, False)]
    assert "srtf vs fifo" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_trains_with_frames_or_patches_on_cpu(arch):
    cfg = t_get_arch(arch).reduced()
    run = train.main(["--device", "cpu", "--reduced", "--arch", arch,
                      "--steps", "2", "--batch", "2", "--seq",
                      str(cfg.n_patches + 8), "--log-every", "1"])
    assert [r["step"] for r in run["steps"]] == [0, 1]
    assert all(np.isfinite(r["nll"]) and r["nll"] > 0 for r in run["steps"])


@pytest.mark.parametrize("seq", [8, 9])
def test_train_cli_refuses_a_sequence_without_two_text_tokens(seq):
    """Reduced pixtral has 8 patches: a sequence of 8 holds no text and
    one of 9 no next-token target."""
    with pytest.raises(ValueError, match="text token"):
        train.main(["--device", "cpu", "--reduced", "--arch", "pixtral-12b",
                    "--steps", "1", "--batch", "1", "--seq", str(seq)])


def test_train_cli_cuts_both_of_whispers_stacks_and_keeps_width():
    args = train.build_parser().parse_args(["--n-layers", "3"])
    cfg = train.arch_config(args, "whisper-large-v3")
    full = t_get_arch("whisper-large-v3")
    assert cfg.n_layers == cfg.encoder.n_layers == 3
    assert dataclasses.replace(
        cfg, n_layers=full.n_layers,
        encoder=dataclasses.replace(cfg.encoder,
                                    n_layers=full.encoder.n_layers)) == full
    assert train.arch_config(args, "pixtral-12b").encoder is None
