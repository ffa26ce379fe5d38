"""The port's model against the JAX package's, on the CPU.

Weights come from the JAX package's ``lm.init`` on reduced configs --
yi-6b (2 layers, d 128, 4 heads, 2 KV heads), mamba2-2.7b (4 SSD layers,
d_inner 256, state 32, chunk 16), recurrentgemma-2b (one (rec, rec, attn)
unit, window 64), recurrentgemma-2b with 5 layers, whose plan has a
second stage (rec, rec), minicpm3-4b (3 MLA layers, q LoRA 64, KV LoRA 64,
qk 32 + 16, v 32), deepseek-v2-lite-16b (a dense MLA layer, then an MLA +
MoE layer of 4 experts top-2 and a shared one) and dbrx-132b (2 GQA + MoE
layers) -- flattened as the checkpointer does and loaded
through ``params_from_numpy``; prompts and decode tokens are numpy arrays
from ``default_rng``.  Both packages then run prefill and four decode
steps, and their logits are compared (logits, not argmax tokens, so a
near-tie cannot hide or fake a difference), and so are their caches, leaf
by leaf.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import _flatten
from repro.configs import get_arch
from repro.models import lm as jlm
from repro_torch.configs import get_arch as t_get_arch
from repro_torch.models import lm
from repro_torch.models.bridge import leaf_dtype, params_from_numpy

B, PROMPT, STEPS, MAX_SEQ = 2, 12, 4, 24
# float32: both packages do the same float32 arithmetic in another order
# (XLA vs ATen matmuls and reductions), ~1e-6 relative on logits of
# magnitude ~1; 1e-4 leaves two orders of margin and still catches any
# wrong rotation, mask, scale or cache slot (those move logits by >1e-2).
F32_TOL = 1e-4
# bfloat16: each framework rounds intermediates to bf16 at its own places
# (matmul outputs, silu, residual adds); bf16 has 8 bits of mantissa, so
# single roundings differ by ~4e-3 relative and two layers compound them.
# The bound is on the relative L2 error of each logits vector.
BF16_REL_L2 = 3e-2
RECURRENT = [("mamba2-2.7b", {}), ("recurrentgemma-2b", {}),
             ("recurrentgemma-2b", {"n_layers": 5})]
LATENT_MOE = ["minicpm3-4b", "deepseek-v2-lite-16b", "dbrx-132b"]


@pytest.fixture(scope="module")
def model():
    cfg = get_arch("yi-6b").reduced()
    params = jlm.init(cfg, jax.random.PRNGKey(0))
    flat = _flatten(params)
    rng = np.random.default_rng(11)
    prompt = rng.integers(0, cfg.vocab_size, (B, PROMPT)).astype(np.int32)
    steps = rng.integers(0, cfg.vocab_size, (STEPS, B)).astype(np.int32)
    return cfg, params, flat, prompt, steps


def _jax_logits(cfg, params, prompt, steps, dtype, backend="xla"):
    logits, caches = jlm.prefill(cfg, params, jnp.asarray(prompt),
                                 max_seq=MAX_SEQ, backend=backend,
                                 dtype=dtype)
    out = [np.asarray(logits, np.float32)]
    lengths = jnp.full((B,), PROMPT, jnp.int32)
    for tok in steps:
        logits, caches = jlm.decode_step(cfg, params, jnp.asarray(tok),
                                         caches, lengths, backend=backend,
                                         dtype=dtype)
        out.append(np.asarray(logits, np.float32))
        lengths = lengths + 1
    return out


def _torch_logits(cfg, tparams, prompt, steps, dtype):
    logits, caches = lm.prefill(cfg, tparams, torch.from_numpy(prompt).long(),
                                max_seq=MAX_SEQ, dtype=dtype)
    out = [logits.float().numpy()]
    lengths = torch.full((B,), PROMPT, dtype=torch.int32)
    for tok in steps:
        logits, caches = lm.decode_step(cfg, tparams,
                                        torch.from_numpy(tok).long(), caches,
                                        lengths, dtype=dtype)
        out.append(logits.float().numpy())
        lengths = lengths + 1
    return out


def test_params_from_numpy_loads_every_leaf(model):
    cfg, _, flat, _, _ = model
    tparams = params_from_numpy(t_get_arch("yi-6b").reduced(), flat,
                                device="cpu", dtype=torch.bfloat16)
    layers = tparams["stage0"]["u0"]
    assert len(layers) == cfg.n_layers
    wq = flat["stage0_u0_mixer_wq"]
    for r, layer in enumerate(layers):
        assert layer["mixer"]["wq"].dtype == torch.bfloat16
        assert layer["norm1"]["scale"].dtype == torch.float32
        np.testing.assert_array_equal(
            layer["mixer"]["wq"].float().numpy(),
            np.asarray(jnp.asarray(wq[r]).astype(jnp.bfloat16), np.float32))
    np.testing.assert_array_equal(tparams["lm_head"]["w"].float().numpy(),
                                  np.asarray(jnp.asarray(flat["lm_head_w"])
                                             .astype(jnp.bfloat16),
                                             np.float32))
    # the slash-separated pytree paths are accepted as well
    slashed = {k.replace("stage0_u0_", "stage0/u0/"): v
               for k, v in flat.items()}
    params_from_numpy(cfg, slashed, device="cpu")


def test_params_from_numpy_rejects_missing_and_misshapen(model):
    cfg, _, flat, _, _ = model
    short = dict(flat)
    short.pop("lm_head_w")
    with pytest.raises(KeyError, match="lm_head"):
        params_from_numpy(cfg, short, device="cpu")
    bad = dict(flat)
    bad["embed_table"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="embed/table"):
        params_from_numpy(cfg, bad, device="cpu")


def test_prefill_and_decode_match_jax_float32(model):
    cfg, params, flat, prompt, steps = model
    want = _jax_logits(cfg, params, prompt, steps, jnp.float32)
    tparams = params_from_numpy(cfg, flat, device="cpu", dtype=torch.float32)
    got = _torch_logits(cfg, tparams, prompt, steps, torch.float32)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, rtol=F32_TOL, atol=F32_TOL)


def test_prefill_and_decode_match_jax_bfloat16(model):
    cfg, params, flat, prompt, steps = model
    want = _jax_logits(cfg, params, prompt, steps, jnp.bfloat16)
    tparams = params_from_numpy(cfg, flat, device="cpu", dtype=torch.bfloat16)
    got = _torch_logits(cfg, tparams, prompt, steps, torch.bfloat16)
    for w, g in zip(want, got):
        rel = np.linalg.norm(g - w, axis=-1) / np.linalg.norm(w, axis=-1)
        assert rel.max() < BF16_REL_L2, rel


def test_prefill_matches_jax_pallas_backend(model):
    """JAX through the Pallas flash kernel (interpret mode) vs the port."""
    cfg, params, flat, prompt, _ = model
    want, _ = jlm.prefill(cfg, params, jnp.asarray(prompt), max_seq=MAX_SEQ,
                          backend="pallas", dtype=jnp.float32)
    tparams = params_from_numpy(cfg, flat, device="cpu", dtype=torch.float32)
    got, _ = lm.prefill(cfg, tparams, torch.from_numpy(prompt).long(),
                        max_seq=MAX_SEQ, dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)


def test_prefill_cache_matches_jax(model):
    """The padded KV cache the prefill leaves behind, layer by layer."""
    cfg, params, flat, prompt, _ = model
    _, jc = jlm.prefill(cfg, params, jnp.asarray(prompt), max_seq=MAX_SEQ,
                        dtype=jnp.float32)
    tparams = params_from_numpy(cfg, flat, device="cpu", dtype=torch.float32)
    _, tc = lm.prefill(cfg, tparams, torch.from_numpy(prompt).long(),
                       max_seq=MAX_SEQ, dtype=torch.float32)
    for name in ("k", "v"):
        np.testing.assert_allclose(tc["stage0"]["u0"][name].numpy(),
                                   np.asarray(jc["stage0"]["u0"][name]),
                                   rtol=F32_TOL, atol=F32_TOL)


def test_random_init_has_reference_shapes(model):
    cfg, _, flat, _, _ = model
    tparams = lm.init(cfg, seed=3, device="cpu", dtype=torch.float32)
    assert len(tparams["stage0"]["u0"]) == cfg.n_layers
    assert tuple(tparams["stage0"]["u0"][0]["mixer"]["wo"].shape) == \
        flat["stage0_u0_mixer_wo"].shape[1:]
    assert tuple(tparams["embed"]["table"].shape) == flat["embed_table"].shape


# ---------------------------------------------- Mamba-2 and the hybrid
@pytest.fixture(scope="module", params=RECURRENT,
                ids=["mamba2", "recurrentgemma", "recurrentgemma-5L"])
def recurrent(request):
    arch, overrides = request.param
    cfg = get_arch(arch).reduced(**overrides)
    tcfg = t_get_arch(arch).reduced(**overrides)
    params = jlm.init(cfg, jax.random.PRNGKey(1))
    flat = _flatten(params)
    rng = np.random.default_rng(12)
    prompt = rng.integers(0, cfg.vocab_size, (B, PROMPT)).astype(np.int32)
    steps = rng.integers(0, cfg.vocab_size, (STEPS, B)).astype(np.int32)
    return cfg, tcfg, params, flat, prompt, steps


def _jax_run(cfg, params, prompt, steps, dtype):
    """Logits of prefill + decode steps, and the caches after the prefill
    and after the last step."""
    logits, caches = jlm.prefill(cfg, params, jnp.asarray(prompt),
                                 max_seq=MAX_SEQ, dtype=dtype)
    out, after_prefill = [np.asarray(logits, np.float32)], caches
    lengths = jnp.full((B,), PROMPT, jnp.int32)
    for tok in steps:
        logits, caches = jlm.decode_step(cfg, params, jnp.asarray(tok),
                                         caches, lengths, dtype=dtype)
        out.append(np.asarray(logits, np.float32))
        lengths = lengths + 1
    return out, after_prefill, caches


def _torch_run(tcfg, tparams, prompt, steps, dtype):
    logits, caches = lm.prefill(tcfg, tparams,
                                torch.from_numpy(prompt).long(),
                                max_seq=MAX_SEQ, dtype=dtype)
    out = [logits.float().numpy()]
    # decode_step updates the caches in place: keep a copy of the prefill's
    after_prefill = {sk: {uk: {k: v.clone() for k, v in unit.items()}
                          for uk, unit in stage.items()}
                     for sk, stage in caches.items()}
    lengths = torch.full((B,), PROMPT, dtype=torch.int32)
    for tok in steps:
        logits, caches = lm.decode_step(tcfg, tparams,
                                        torch.from_numpy(tok).long(), caches,
                                        lengths, dtype=dtype)
        out.append(logits.float().numpy())
        lengths = lengths + 1
    return out, after_prefill, caches


def _assert_same_caches(got, want, tol):
    assert sorted(got) == sorted(want)
    for sk in sorted(want):
        assert sorted(got[sk]) == sorted(want[sk])
        for uk in sorted(want[sk]):
            assert sorted(got[sk][uk]) == sorted(want[sk][uk])
            for name in sorted(want[sk][uk]):
                w = np.asarray(want[sk][uk][name])
                g = got[sk][uk][name]
                assert tuple(g.shape) == w.shape, (sk, uk, name)
                assert str(g.dtype).split(".")[-1] == str(w.dtype), \
                    (sk, uk, name)
                np.testing.assert_allclose(g.float().numpy(),
                                           w.astype(np.float32), rtol=tol,
                                           atol=tol, err_msg=f"{sk}/{uk}/"
                                           f"{name}")


def test_recurrent_prefill_and_decode_match_jax_float32(recurrent):
    cfg, tcfg, params, flat, prompt, steps = recurrent
    want, want_c0, want_c = _jax_run(cfg, params, prompt, steps, jnp.float32)
    tparams = params_from_numpy(tcfg, flat, device="cpu",
                                dtype=torch.float32)
    got, got_c0, got_c = _torch_run(tcfg, tparams, prompt, steps,
                                    torch.float32)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, rtol=F32_TOL, atol=F32_TOL)
    _assert_same_caches(got_c0, want_c0, F32_TOL)
    _assert_same_caches(got_c, want_c, F32_TOL)


def test_recurrent_prefill_and_decode_match_jax_bfloat16(recurrent):
    cfg, tcfg, params, flat, prompt, steps = recurrent
    want, _, _ = _jax_run(cfg, params, prompt, steps, jnp.bfloat16)
    tparams = params_from_numpy(tcfg, flat, device="cpu",
                                dtype=torch.bfloat16)
    got, _, _ = _torch_run(tcfg, tparams, prompt, steps, torch.bfloat16)
    for w, g in zip(want, got):
        rel = np.linalg.norm(g - w, axis=-1) / np.linalg.norm(w, axis=-1)
        assert rel.max() < BF16_REL_L2, rel


def test_recurrent_prefill_matches_jax_pallas_backend(recurrent):
    """JAX through the Pallas SSD / RG-LRU / flash kernels (interpret
    mode) vs the port, logits and caches."""
    cfg, tcfg, params, flat, prompt, _ = recurrent
    want, want_c = jlm.prefill(cfg, params, jnp.asarray(prompt),
                               max_seq=MAX_SEQ, backend="pallas",
                               dtype=jnp.float32)
    tparams = params_from_numpy(tcfg, flat, device="cpu",
                                dtype=torch.float32)
    got, got_c = lm.prefill(tcfg, tparams, torch.from_numpy(prompt).long(),
                            max_seq=MAX_SEQ, dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)
    _assert_same_caches(got_c, want_c, F32_TOL)


def test_bridge_keeps_the_float32_leaves(recurrent):
    """a_log, dt_bias and a_param stay float32 (JAX reads them so), while
    the matrices, conv weights and d_skip go to bf16."""
    _, tcfg, _, flat, _, _ = recurrent
    tparams = params_from_numpy(tcfg, flat, device="cpu",
                                dtype=torch.bfloat16)
    mixer = tparams["stage0"]["u0"][0]["mixer"]
    kept = [k for k in ("a_log", "dt_bias", "a_param") if k in mixer]
    assert kept
    for key in kept:
        assert mixer[key].dtype == torch.float32
        np.testing.assert_array_equal(
            mixer[key].numpy(), flat[f"stage0_u0_mixer_{key}"][0])
    for key in ("w_x", "conv_x_w", "d_skip", "wx", "conv_w", "gate_a"):
        if key in mixer:
            assert mixer[key].dtype == torch.bfloat16
    assert leaf_dtype("stage0/u0/mixer/gate_norm/scale", torch.bfloat16) \
        == torch.float32


def test_recurrent_random_init_has_reference_shapes_and_values(recurrent):
    cfg, tcfg, _, flat, _, _ = recurrent
    tparams = lm.init(tcfg, seed=3, device="cpu", dtype=torch.float32)
    shapes = lm.param_shapes(tcfg)
    assert sorted(k.replace("/", "_") for k in shapes) == sorted(flat)
    for key, (shape, _) in shapes.items():
        assert flat[key.replace("/", "_")].shape == shape, key
    mixer = tparams["stage0"]["u0"][0]["mixer"]
    # The non-random leaves are the JAX package's own values.  torch and
    # jnp linspace may differ by an ulp, and a_param = log(expm1(-log p))
    # multiplies that by up to 1 / (1 - p) = 1000 near p = 0.999.
    for key in ("a_log", "a_param", "d_skip", "dt_bias"):
        if key in mixer:
            np.testing.assert_allclose(mixer[key].numpy(),
                                       flat[f"stage0_u0_mixer_{key}"][0],
                                       rtol=1e-4, atol=1e-6)


def test_prefill_refuses_a_sequence_longer_than_the_window():
    tcfg = t_get_arch("recurrentgemma-2b").reduced()
    tparams = lm.init(tcfg, seed=0, device="cpu", dtype=torch.float32)
    prompt = torch.zeros((1, 8), dtype=torch.long)
    window = tcfg.rglru.window
    lm.prefill(tcfg, tparams, prompt, max_seq=window)
    with pytest.raises(ValueError, match="window"):
        lm.prefill(tcfg, tparams, prompt, max_seq=window + 1)


def reference_window_errors(steps: int = 8):
    """(position, max abs, relative L2) of the JAX package's decode-step
    logits against its full-sequence forward, reduced recurrentgemma-2b
    (window 64), fp32, a prompt ending 4 positions before the window."""
    cfg = get_arch("recurrentgemma-2b").reduced()
    window = cfg.rglru.window
    params = jlm.init(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(5)
    prompt_len = window - 4
    toks = rng.integers(0, cfg.vocab_size,
                        (B, prompt_len + steps)).astype(np.int32)
    full, _, _ = jlm.forward(cfg, params, jnp.asarray(toks),
                             dtype=jnp.float32)
    _, caches = jlm.prefill(cfg, params, jnp.asarray(toks[:, :prompt_len]),
                            max_seq=window, dtype=jnp.float32)
    lengths = jnp.full((B,), prompt_len, jnp.int32)
    out = []
    for t in range(prompt_len, prompt_len + steps):
        logits, caches = jlm.decode_step(cfg, params, jnp.asarray(toks[:, t]),
                                         caches, lengths, dtype=jnp.float32)
        got, want = np.asarray(logits), np.asarray(full[:, t])
        out.append((t, float(np.abs(got - want).max()),
                    float((np.linalg.norm(got - want, axis=-1)
                           / np.linalg.norm(want, axis=-1)).max())))
        lengths = lengths + 1
    return window, out


def test_reference_decode_past_the_window_departs_from_its_forward():
    """Why the port refuses max_seq > window: the JAX package's local layer
    keeps exactly ``window`` cache slots, and its decode step writes at
    slot ``length`` (``repro.models.attention.gqa_decode`` takes the ring
    branch only when the cache is longer than the window), so from
    ``length == window`` on the write is dropped and the step attends to a
    stale cache.  Up to the window the decode steps equal the full-sequence
    forward (which masks the window correctly); past it they do not."""
    window, errors = reference_window_errors()
    inside = [rel for t, _, rel in errors if t < window]
    past = [rel for t, _, rel in errors if t >= window]
    assert inside and past
    assert max(inside) < F32_TOL, errors
    assert min(past) > 100 * F32_TOL, errors


# ------------------------------------------------- MLA and MoE models
@pytest.fixture(scope="module", params=LATENT_MOE)
def latent(request):
    arch = request.param
    cfg, tcfg = get_arch(arch).reduced(), t_get_arch(arch).reduced()
    params = jlm.init(cfg, jax.random.PRNGKey(2))
    flat = _flatten(params)
    rng = np.random.default_rng(13)
    prompt = rng.integers(0, cfg.vocab_size, (B, PROMPT)).astype(np.int32)
    steps = rng.integers(0, cfg.vocab_size, (STEPS, B)).astype(np.int32)
    return cfg, tcfg, params, flat, prompt, steps


def test_latent_moe_prefill_and_decode_match_jax_float32(latent):
    """Logits of prefill and four decode steps, and the caches ({c_kv,
    k_rope} after ``_pad_mla`` for MLA, {k, v} for dbrx) after the prefill
    and after the last step."""
    cfg, tcfg, params, flat, prompt, steps = latent
    want, want_c0, want_c = _jax_run(cfg, params, prompt, steps, jnp.float32)
    tparams = params_from_numpy(tcfg, flat, device="cpu",
                                dtype=torch.float32)
    got, got_c0, got_c = _torch_run(tcfg, tparams, prompt, steps,
                                    torch.float32)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, rtol=F32_TOL, atol=F32_TOL)
    _assert_same_caches(got_c0, want_c0, F32_TOL)
    _assert_same_caches(got_c, want_c, F32_TOL)


def test_latent_moe_prefill_and_decode_match_jax_bfloat16(latent):
    cfg, tcfg, params, flat, prompt, steps = latent
    want, _, _ = _jax_run(cfg, params, prompt, steps, jnp.bfloat16)
    tparams = params_from_numpy(tcfg, flat, device="cpu",
                                dtype=torch.bfloat16)
    got, _, _ = _torch_run(tcfg, tparams, prompt, steps, torch.bfloat16)
    for w, g in zip(want, got):
        rel = np.linalg.norm(g - w, axis=-1) / np.linalg.norm(w, axis=-1)
        assert rel.max() < BF16_REL_L2, rel


def test_latent_moe_prefill_matches_jax_pallas_backend(latent):
    """JAX through its Pallas flash kernel (interpret mode), which takes
    MLA's qk 48 / v 32 as it is, vs the port."""
    cfg, tcfg, params, flat, prompt, _ = latent
    want, want_c = jlm.prefill(cfg, params, jnp.asarray(prompt),
                               max_seq=MAX_SEQ, backend="pallas",
                               dtype=jnp.float32)
    tparams = params_from_numpy(tcfg, flat, device="cpu",
                                dtype=torch.float32)
    got, got_c = lm.prefill(tcfg, tparams, torch.from_numpy(prompt).long(),
                            max_seq=MAX_SEQ, dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)
    _assert_same_caches(got_c, want_c, F32_TOL)


def test_latent_moe_random_init_and_bridge_dtypes(latent):
    """``lm.init`` has the JAX package's leaves and shapes; the bridge
    keeps the MLA norms' scales float32 (the JAX package multiplies by
    them in float32) and casts the attention, router, expert and shared
    expert weights to bf16 (it casts them at use)."""
    _, tcfg, _, flat, _, _ = latent
    shapes = lm.param_shapes(tcfg)
    assert sorted(k.replace("/", "_") for k in shapes) == sorted(flat)
    for key, (shape, _) in shapes.items():
        assert flat[key.replace("/", "_")].shape == shape, key
    tparams = lm.init(tcfg, seed=4, device="cpu")
    for si in range(len(lm.build_plan(tcfg))):
        layer = tparams[f"stage{si}"]["u0"][0]
        for name, t in layer["mixer"].items():
            if name.endswith("_norm"):
                assert t["scale"].dtype == torch.float32, name
            else:
                assert t.dtype == torch.bfloat16, name
        assert all(w.dtype == torch.bfloat16
                   for w in _leaves(layer["ffn"]))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def test_deepseek_first_stage_is_dense_at_its_own_width():
    """deepseek-v2-lite's first layer keeps a dense FFN of d_ff_dense
    (10944 at full width), the rest are MoE of 64 experts of 1408."""
    cfg = t_get_arch("deepseek-v2-lite-16b")
    shapes = lm.param_shapes(cfg)
    assert shapes["stage0/u0/ffn/gate/w"][0] == (1, 2048, 10944)
    assert shapes["stage1/u0/ffn/gate_w"][0] == (26, 64, 2048, 1408)
    assert shapes["stage1/u0/ffn/shared/down/w"][0] == (26, 2816, 2048)
    assert shapes["stage0/u0/mixer/wq"][0] == (1, 2048, 16, 192)
    total = sum(int(np.prod(s)) for s, _ in shapes.values())
    assert 15.5e9 < total < 15.9e9


@pytest.mark.parametrize("arch", ["yi-6b", "mamba2-2.7b", "recurrentgemma-2b",
                                  "minicpm3-4b", "deepseek-v2-lite-16b",
                                  "dbrx-132b"])
def test_float32_compute_on_bf16_weights_equals_a_float32_copy(arch):
    """Every weight is cast at its use, so float32 compute on the bf16
    weights is the same float32 arithmetic on the same values as on their
    float32 copy (exact casts; 1e-6 leaves room only for a matrix product
    that blocks differently at another alignment): the chip run's float32
    floor needs no float32 copy of the weights."""
    cfg = t_get_arch(arch).reduced()
    params = lm.init(cfg, seed=5, device="cpu")

    def to32(tree):
        if isinstance(tree, dict):
            return {k: to32(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to32(v) for v in tree]
        return tree.float()

    rng = np.random.default_rng(14)
    prompt = rng.integers(0, cfg.vocab_size, (B, PROMPT)).astype(np.int32)
    steps = rng.integers(0, cfg.vocab_size, (STEPS, B)).astype(np.int32)
    got, _, _ = _torch_run(cfg, params, prompt, steps, torch.float32)
    want, _, _ = _torch_run(cfg, to32(params), prompt, steps, torch.float32)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
