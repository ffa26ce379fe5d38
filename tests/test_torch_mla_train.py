"""Training MLA at its full head dims against the JAX package, on the CPU.

The reduced configs' MLA (qk 32 + 16, v 32) pairs with no flash pair and
is never padded.  Here tiny configs keep minicpm3-4b's and
deepseek-v2-lite-16b's published head dims (qk 64 + 32 padded to 128
beside v 64; qk 128 + 64 beside v 128) at 2 layers and d_model 64, with
small experts for deepseek (one dense layer, one MoE layer): one step's
loss and every stacked gradient leaf through the port's ``mla_apply``
(which zero-pads q and k to the flash pair and runs the plain forward
and backward under ``ops.FlashAttention``) against
``jax.value_and_grad`` of the reference loss, float32, within the
training tests' 1e-4.  Inputs come from ``np.random.default_rng``,
weights from the reference's ``lm.init``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import _flatten
from repro.configs import get_arch
from repro.configs.base import MLAConfig
from repro.models import lm as jlm
from repro_torch import intra_op_threads, tree
from repro_torch.configs import get_arch as t_get_arch
from repro_torch.configs.base import MLAConfig as TMLAConfig
from repro_torch.kernels import ops
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


F32_TOL = 1e-4          # tests/test_torch_train.py's float32 tolerance
LOSS_TOL = 1e-5
B, S = 2, 16

TINY = {
    # arch: (heads, MLA (kv_lora, q_lora, qk_nope, qk_rope, v), the
    # (D, Dv) pair the flash op must see)
    "minicpm3-4b": (4, (32, 32, 64, 32, 64), (128, 64)),
    "deepseek-v2-lite-16b": (2, (32, None, 128, 64, 128), (192, 128)),
}


def _tiny(get, mla_cls, arch):
    heads, (kv_lora, q_lora, nope, rope, v), _ = TINY[arch]
    return get(arch).reduced(
        n_layers=2, d_model=64, d_ff=64, n_heads=heads, n_kv_heads=heads,
        mla=mla_cls(kv_lora_rank=kv_lora, q_lora_rank=q_lora,
                    qk_nope_dim=nope, qk_rope_dim=rope, v_head_dim=v))


def _rel_l2(got, want) -> float:
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("arch", sorted(TINY))
def test_full_head_dim_mla_loss_and_every_stacked_gradient_match_jax(
        arch, monkeypatch):
    cfg = _tiny(get_arch, MLAConfig, arch)
    tcfg = _tiny(t_get_arch, TMLAConfig, arch)
    assert (cfg.moe is not None) == (arch == "deepseek-v2-lite-16b")
    params = jlm.init(cfg, jax.random.PRNGKey(0))
    tokens = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)

    def f(p):
        return jlm.loss_fn(cfg, p, {"tokens": jnp.asarray(tokens)},
                           dtype=jnp.float32)

    (jt, jm), jg = jax.value_and_grad(f, has_aux=True)(params)
    jg = _flatten(jg)

    # the flash op sees q and k padded to the pair, v at its own width
    seen = []
    flash = ops.flash_attention

    def recording(q, k, v, **kw):
        seen.append((q.shape[-1], k.shape[-1], v.shape[-1]))
        return flash(q, k, v, **kw)

    monkeypatch.setattr(ops, "flash_attention", recording)
    tparams = params_from_numpy(tcfg, _flatten(params), device="cpu",
                                dtype=torch.float32, stacked=True)
    for p in tree.leaves(tparams):
        p.requires_grad_()
    tt, tm = lm.loss_fn(tcfg, tparams,
                        {"tokens": torch.from_numpy(tokens).long()},
                        dtype=torch.float32)
    tt.backward()
    D, Dv = TINY[arch][2]
    assert seen == [(D, D, Dv)] * cfg.n_layers

    assert abs(float(tt.detach()) - float(jt)) <= LOSS_TOL * abs(float(jt))
    for name in ("nll", "aux", "z"):
        np.testing.assert_allclose(float(tm[name].detach()), float(jm[name]),
                                   rtol=LOSS_TOL, atol=1e-7, err_msg=name)
    paths = [p for p, _ in tree.leaves_with_path(tparams)]
    assert sorted(p.replace("/", "_") for p in paths) == sorted(jg)
    for path, leaf in tree.leaves_with_path(tparams):
        assert leaf.grad is not None, path
        assert _rel_l2(leaf.grad, jg[path.replace("/", "_")]) <= F32_TOL, \
            path
