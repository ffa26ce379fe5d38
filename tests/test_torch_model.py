"""The port's model against the JAX package's, on the CPU.

Weights come from the JAX package's ``lm.init`` on reduced yi-6b (2
layers, d 128, 4 heads, 2 KV heads), flattened as the checkpointer does
and loaded through ``params_from_numpy``; prompts and decode tokens are
numpy arrays from ``default_rng``.  Both packages then run prefill and four
decode steps, and their logits are compared (logits, not argmax tokens, so
a near-tie cannot hide or fake a difference).
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
from repro_torch.models.bridge import params_from_numpy

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


@pytest.mark.parametrize("arch", ["minicpm3-4b", "mamba2-2.7b",
                                  "recurrentgemma-2b", "dbrx-132b",
                                  "whisper-large-v3"])
def test_later_slices_raise_not_implemented(arch):
    with pytest.raises(NotImplementedError, match="not ported yet"):
        lm.init(t_get_arch(arch).reduced(), device="cpu")


def test_random_init_has_reference_shapes(model):
    cfg, _, flat, _, _ = model
    tparams = lm.init(cfg, seed=3, device="cpu", dtype=torch.float32)
    assert len(tparams["stage0"]["u0"]) == cfg.n_layers
    assert tuple(tparams["stage0"]["u0"][0]["mixer"]["wo"].shape) == \
        flat["stage0_u0_mixer_wo"].shape[1:]
    assert tuple(tparams["embed"]["table"].shape) == flat["embed_table"].shape
