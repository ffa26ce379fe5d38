"""Dense GQA at yi-34b's and mistral-nemo-12b's own shapes, the port
against the JAX package on the CPU.

The reduced configs of both archs have 4 heads over 2, which shows neither
arch's shape: yi-34b groups 56 query heads over 8 KV heads (G 7, odd), and
mistral-nemo-12b's heads are 32 x 128 = 4096 wide against a d_model of
5120.  Here each is reduced with its own shape kept at a small width:

- yi-34b: ``.reduced()`` with 7 heads over 1 (G 7), head dim 32, d_model
  224 (3 layers);
- mistral-nemo-12b: ``.reduced()`` with 8 heads over 2, head dim 32 and
  d_model 128, so the heads are 256 wide against a residual of 128.

Weights come from the JAX package's ``lm.init``, flattened as its
checkpointer flattens them and loaded through ``params_from_numpy``;
prompts and decode tokens are numpy arrays from ``default_rng``.  Both
packages run prefill and four decode steps (logits and caches compared;
the reference also through its Pallas flash and decode kernels in
interpret mode), and the loss and every stacked gradient.

Tolerances, as ``tests/test_torch_model.py`` and
``tests/test_torch_train.py`` hold the other archs: float32 1e-4 (the
same float32 arithmetic in another order, ~1e-6 relative); losses 1e-5
relative; bf16 logits and gradient leaves within 3e-2 relative L2 and the
bf16 loss within 1e-3 relative (each framework rounds products,
activations and residual adds to bf16 at its own places).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import _flatten
from repro.configs import get_arch
from repro.models import lm as jlm
from repro_torch import intra_op_threads, tree
from repro_torch.configs import get_arch as t_get_arch
from repro_torch.models import lm
from repro_torch.models.bridge import params_from_numpy


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The module's CPU work on one intra-op thread: its small products
    would wake every thread, which under the suite's parallel workers
    makes them many times slower (the rule of ``README.md``'s "Tests on
    the CPU")."""
    with intra_op_threads(1):
        yield


SHAPES = {
    "yi-34b": dict(n_heads=7, n_kv_heads=1, head_dim=32, d_model=224),
    "mistral-nemo-12b": dict(n_heads=8, n_kv_heads=2, head_dim=32,
                             d_model=128),
}
B, PROMPT, STEPS, MAX_SEQ = 2, 12, 4, 24
TRAIN_S = 16
F32_TOL = 1e-4
LOSS_TOL = 1e-5
BF16_REL_L2 = 3e-2
BF16_LOSS_TOL = 1e-3


@pytest.fixture(scope="module", params=sorted(SHAPES))
def model(request):
    arch = request.param
    cfg = get_arch(arch).reduced(**SHAPES[arch])
    tcfg = t_get_arch(arch).reduced(**SHAPES[arch])
    params = jlm.init(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(17)
    prompt = rng.integers(0, cfg.vocab_size, (B, PROMPT)).astype(np.int32)
    steps = rng.integers(0, cfg.vocab_size, (STEPS, B)).astype(np.int32)
    tokens = rng.integers(0, cfg.vocab_size, (B, TRAIN_S)).astype(np.int32)
    return arch, cfg, tcfg, params, _flatten(params), prompt, steps, \
        tokens


def _rel_l2(got, want) -> float:
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _jax_run(cfg, params, prompt, steps, dtype, backend="xla"):
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
    return out, caches


def _torch_run(tcfg, tparams, prompt, steps, dtype):
    logits, caches = lm.prefill(tcfg, tparams,
                                torch.from_numpy(prompt).long(),
                                max_seq=MAX_SEQ, dtype=dtype)
    out = [logits.float().numpy()]
    lengths = torch.full((B,), PROMPT, dtype=torch.int32)
    for tok in steps:
        logits, caches = lm.decode_step(tcfg, tparams,
                                        torch.from_numpy(tok).long(), caches,
                                        lengths, dtype=dtype)
        out.append(logits.float().numpy())
        lengths = lengths + 1
    return out, caches


def test_configs_keep_the_full_width_shapes(model):
    """The small configs keep what sets each full-width arch apart."""
    arch, cfg, tcfg = model[:3]
    full = t_get_arch(arch)
    assert (tcfg.n_heads, tcfg.n_kv_heads, tcfg.head_dim, tcfg.d_model) \
        == (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model)
    if arch == "yi-34b":
        assert full.n_heads // full.n_kv_heads == 7 \
            == cfg.n_heads // cfg.n_kv_heads
    else:
        assert full.n_heads * full.head_dim != full.d_model
        assert cfg.n_heads * cfg.head_dim != cfg.d_model


def test_prefill_and_decode_match_jax_float32(model):
    _, cfg, tcfg, params, flat, prompt, steps, _ = model
    want, jc = _jax_run(cfg, params, prompt, steps, jnp.float32)
    tparams = params_from_numpy(tcfg, flat, device="cpu",
                                dtype=torch.float32)
    got, tc = _torch_run(tcfg, tparams, prompt, steps, torch.float32)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, rtol=F32_TOL, atol=F32_TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(tc["stage0"]["u0"][name].numpy(),
                                   np.asarray(jc["stage0"]["u0"][name]),
                                   rtol=F32_TOL, atol=F32_TOL)


def test_prefill_and_decode_match_jax_bfloat16(model):
    _, cfg, tcfg, params, flat, prompt, steps, _ = model
    want, _ = _jax_run(cfg, params, prompt, steps, jnp.bfloat16)
    tparams = params_from_numpy(tcfg, flat, device="cpu",
                                dtype=torch.bfloat16)
    got, _ = _torch_run(tcfg, tparams, prompt, steps, torch.bfloat16)
    for w, g in zip(want, got):
        rel = np.linalg.norm(g - w, axis=-1) / np.linalg.norm(w, axis=-1)
        assert rel.max() < BF16_REL_L2, rel


def test_prefill_and_decode_match_jax_pallas_backend(model):
    """The JAX package through its Pallas flash and decode kernels
    (interpret mode) against the port."""
    _, cfg, tcfg, params, flat, prompt, steps, _ = model
    want, _ = _jax_run(cfg, params, prompt, steps, jnp.float32,
                       backend="pallas")
    tparams = params_from_numpy(tcfg, flat, device="cpu",
                                dtype=torch.float32)
    got, _ = _torch_run(tcfg, tparams, prompt, steps, torch.float32)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, rtol=F32_TOL, atol=F32_TOL)


def _losses(cfg, tcfg, params, flat, tokens, jdt, tdt):
    def f(p):
        return jlm.loss_fn(cfg, p, {"tokens": jnp.asarray(tokens)},
                           dtype=jdt)

    (jt, _), jg = jax.value_and_grad(f, has_aux=True)(params)
    tparams = params_from_numpy(tcfg, flat, device="cpu",
                                dtype=torch.float32, stacked=True)
    for p in tree.leaves(tparams):
        p.requires_grad_()
    tt, _ = lm.loss_fn(tcfg, tparams,
                       {"tokens": torch.from_numpy(tokens).long()},
                       dtype=tdt)
    tt.backward()
    return float(jt), float(tt.detach()), _flatten(jg), tparams


def test_loss_and_every_stacked_gradient_match_jax_float32(model):
    _, cfg, tcfg, params, flat, _, _, tokens = model
    jt, tt, jg, tparams = _losses(cfg, tcfg, params, flat, tokens,
                                  jnp.float32, torch.float32)
    assert abs(tt - jt) <= LOSS_TOL * abs(jt)
    paths = [p for p, _ in tree.leaves_with_path(tparams)]
    assert sorted(p.replace("/", "_") for p in paths) == sorted(jg)
    for path, leaf in tree.leaves_with_path(tparams):
        assert leaf.grad is not None, path
        assert _rel_l2(leaf.grad, jg[path.replace("/", "_")]) <= F32_TOL, \
            path


def test_loss_and_every_stacked_gradient_match_jax_bfloat16(model):
    _, cfg, tcfg, params, flat, _, _, tokens = model
    jt, tt, jg, tparams = _losses(cfg, tcfg, params, flat, tokens,
                                  jnp.bfloat16, torch.bfloat16)
    assert abs(tt - jt) <= BF16_LOSS_TOL * abs(jt)
    for path, leaf in tree.leaves_with_path(tparams):
        assert _rel_l2(leaf.grad, jg[path.replace("/", "_")]) \
            <= BF16_REL_L2, path
