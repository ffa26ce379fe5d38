"""The port's MoE and MLA modules against the JAX package's, on the CPU.

Inputs are numpy arrays from ``default_rng``; both packages take them.
MoE: the batched dispatch, combine and expert products against the JAX
package's per-row functions under ``jax.vmap`` (as its ``moe.moe_apply``
calls them), with and without dropped entries, in float32 and bf16; the
routing, with forced ties, against ``jax.lax.top_k``'s order; and the
dense oracle.  MLA: prefill (naive expansion through the flash op) and
the absorbed decode step against ``repro.models.mla`` in float32, and the
zero-padding of q and k that the flash kernel's head-dim pairs ask for.

Tolerances: float32 1e-4 (both packages do the same float32 arithmetic
in another order, ~1e-6 relative); bf16 results of the dispatch and
combine are bitwise equal, since neither rounds anything but the
products and sums the JAX package rounds, in its order; bf16 expert
products (matrix products that accumulate in another order, then round)
within 3e-2 relative L2 of each output row, the bound the models are
held to.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch
from repro.kernels import ops as jops, ref as jref
from repro.models import mla as jmla, moe as jmoe
from repro_torch import intra_op_threads
from repro_torch.configs import get_arch as t_get_arch
from repro_torch.kernels import ops, ref
from repro_torch.models import mla, moe


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The module's CPU work on one intra-op thread: its small products
    would wake every thread, which under the suite's parallel workers
    makes them many times slower (the rule of ``README.md``'s "Tests on
    the CPU")."""
    with intra_op_threads(1):
        yield


F32_TOL = 1e-4
BF16_REL_L2 = 3e-2


def _np32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _assert_close(got, want, dtype):
    got, want = _np32(got), _np32(want)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
    else:
        # a row whose every entry was dropped is zero on both sides
        rel = np.linalg.norm(got - want, axis=-1) / np.maximum(
            np.linalg.norm(want, axis=-1), 1e-30)
        assert rel.max() < BF16_REL_L2, rel.max()


def _routing(rng, B, T, E, K):
    """Distinct experts per token (as top-k gives them), gates in (0, 1)."""
    idx = np.argsort(rng.random((B, T, E)), axis=-1)[..., :K]
    return idx.astype(np.int32), rng.random((B, T, K)).astype(np.float32)


def _experts(rng, E, D, F):
    return tuple((rng.standard_normal(s) * 0.3).astype(np.float32)
                 for s in ((E, D, F), (E, D, F), (E, F, D)))


# capacity 2 and 5 drop entries (T * K / E = 7.5 a row on average); 20
# none.  K 3: the order of a token's contributions matters from 3 on.
CAPACITIES = [2, 5, 20]
B, T, D, E, K, FF = 3, 10, 8, 4, 3, 16


@pytest.mark.parametrize("capacity", CAPACITIES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_dispatch_matches_jax(capacity, dtype):
    rng = np.random.default_rng(20 + capacity)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    idx, gate = _routing(rng, B, T, E, K)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    want, _ = jax.vmap(lambda a, i, g: jops.moe_dispatch(
        a, i, g, E, capacity))(jx, idx, gate)
    got, _ = ops.moe_dispatch(torch.from_numpy(x).to(getattr(torch, dtype)),
                              torch.from_numpy(idx).long(),
                              torch.from_numpy(gate), E, capacity)
    np.testing.assert_array_equal(_np32(got), _np32(want))


@pytest.mark.parametrize("capacity", CAPACITIES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_combine_matches_jax(capacity, dtype):
    """Expert outputs y back to token order, weighted, for the same y:
    dropped entries add nothing, and each token's contributions are summed
    in the JAX package's order (bitwise equal in bf16 too)."""
    rng = np.random.default_rng(30 + capacity)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    y = rng.standard_normal((B, E, capacity, D)).astype(np.float32)
    idx, gate = _routing(rng, B, T, E, K)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    def jax_row(a, i, g, yr):
        _, meta = jops.moe_dispatch(a, i, g, E, capacity)
        return jops.moe_combine(yr, meta, T)

    want = jax.vmap(jax_row)(jnp.asarray(x).astype(jdt), idx,
                             jnp.asarray(gate).astype(jdt),
                             jnp.asarray(y).astype(jdt))
    _, meta = ops.moe_dispatch(torch.from_numpy(x).to(tdt),
                               torch.from_numpy(idx).long(),
                               torch.from_numpy(gate).to(tdt), E, capacity)
    got = ops.moe_combine(torch.from_numpy(y).to(tdt), meta)
    assert got.dtype == tdt
    if dtype == "bfloat16":
        np.testing.assert_array_equal(_np32(got), _np32(want))
    else:
        np.testing.assert_allclose(_np32(got), _np32(want), rtol=F32_TOL,
                                   atol=F32_TOL)


@pytest.mark.parametrize("capacity", CAPACITIES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_apply_matches_jax(capacity, dtype):
    rng = np.random.default_rng(40 + capacity)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    idx, gate = _routing(rng, B, T, E, K)
    gw, uw, dw = _experts(rng, E, D, FF)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jax.vmap(lambda a, i, g: jops.moe_apply(
        a, gw, uw, dw, i, g, capacity, dtype=jdt))(
            jnp.asarray(x).astype(jdt), idx, jnp.asarray(gate).astype(jdt))
    got = ops.moe_apply(torch.from_numpy(x).to(tdt), torch.from_numpy(gw),
                        torch.from_numpy(uw), torch.from_numpy(dw),
                        torch.from_numpy(idx).long(),
                        torch.from_numpy(gate).to(tdt), capacity, dtype=tdt)
    _assert_close(got, want, dtype)


def test_moe_apply_without_drops_matches_the_dense_oracle():
    """As ``tests/test_kernels.py``: capacity T drops nothing, so the
    dispatch equals every token through its experts, weighted."""
    rng = np.random.default_rng(8)
    Tn, Dn, En, Fn, Kn = 64, 16, 4, 32, 2
    x = torch.from_numpy(rng.standard_normal((1, Tn, Dn), dtype=np.float32))
    gw, uw, dw = (torch.from_numpy(w * 0.3) for w in _experts(rng, En, Dn,
                                                               Fn))
    probs = torch.softmax(torch.from_numpy(
        rng.standard_normal((1, Tn, En), dtype=np.float32)), dim=-1)
    gate, idx = torch.topk(probs, Kn, dim=-1)
    gate = gate / gate.sum(-1, keepdim=True)
    dense = torch.zeros((Tn, En)).scatter_(1, idx[0], gate[0])
    want = ref.moe_dense(x[0], gw, uw, dw, dense)
    got = ops.moe_apply(x, gw, uw, dw, idx, gate, capacity=Tn,
                        dtype=torch.float32)
    np.testing.assert_allclose(got[0].numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_moe_dense_oracle_matches_jax():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((12, 8)).astype(np.float32)
    gw, uw, dw = _experts(rng, 4, 8, 16)
    probs = rng.random((12, 4)).astype(np.float32)
    want = jref.moe_dense(x, gw, uw, dw, probs)
    got = ref.moe_dense(*(torch.from_numpy(a) for a in (x, gw, uw, dw,
                                                         probs)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)


# ---------------------------------------------------------------- routing
def _moe_layer(rng, d, n_experts, n_shared, ff, group):
    """A MoE layer's parameters (float32 numpy) whose router repeats each
    column ``group`` times: the experts of a group tie exactly."""
    router = (rng.standard_normal((d, n_experts)) / np.sqrt(d)).astype(
        np.float32)
    router = router[:, np.arange(n_experts) // group * group]
    gw, uw, dw = _experts(rng, n_experts, d, ff)
    p = {"router": router, "gate_w": gw, "up_w": uw, "down_w": dw}
    if n_shared:
        sf = n_shared * ff
        p["shared"] = {k: {"w": (rng.standard_normal(s) * 0.3).astype(
            np.float32)} for k, s in (("gate", (d, sf)), ("up", (d, sf)),
                                      ("down", (sf, d)))}
    return p


def _to_torch(tree, dtype):
    if isinstance(tree, dict):
        return {k: _to_torch(v, dtype) for k, v in tree.items()}
    return torch.from_numpy(tree).to(dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "dbrx-132b"])
def test_moe_layer_with_forced_ties_matches_jax(arch, dtype):
    """Repeated router columns make groups of top_k - 1 experts tie
    exactly, so a tied group straddles the k-th place; the port must pick
    the lower index first, as ``jax.lax.top_k`` does, or the routed
    experts (and the outputs) differ.  Full expert count and top-k of the
    arch, narrow widths."""
    cfg = get_arch(arch).moe
    tcfg = t_get_arch(arch).moe
    rng = np.random.default_rng(50)
    S, d, ff = 16, 32, 24
    p = _moe_layer(rng, d, cfg.n_experts, cfg.n_shared, ff,
                   group=cfg.top_k - 1)
    x = rng.standard_normal((2, S, d)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jx, tx = jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)

    jprobs = jax.nn.softmax((jx @ jnp.asarray(p["router"]).astype(jdt))
                            .astype(jnp.float32), axis=-1)
    _, jidx = jax.lax.top_k(jprobs, cfg.top_k)
    tp = _to_torch(p, tdt)
    _, _, tidx = moe.route(tp, tx, tcfg, tdt)
    # the ties are real: tokens whose k-th and (k+1)-th probabilities are
    # equal, so which of the tied experts is routed to is the order's
    top = np.sort(np.asarray(jprobs), axis=-1)[..., ::-1]
    assert (top[..., cfg.top_k - 1] == top[..., cfg.top_k]).mean() > 0.5
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))

    want, want_aux = jmoe.moe_apply(jax.tree_util.tree_map(jnp.asarray, p),
                                    jx, cfg, dtype=jdt)
    got, got_aux = moe.moe_apply(tp, tx, tcfg, dtype=tdt)
    _assert_close(got, want, dtype)
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=1e-5)


def test_route_puts_the_lower_expert_first_among_equals():
    """The tie order itself, on probabilities given outright."""
    probs = torch.tensor([[[0.1, 0.3, 0.3, 0.3]]])
    p = {"router": torch.eye(4)}
    logits = torch.log(probs)
    _, _, idx = moe.route(p, logits, t_get_arch("dbrx-132b").moe,
                          torch.float32)
    _, jidx = jax.lax.top_k(jnp.asarray(probs.numpy()), 4)
    assert idx.tolist() == [[[1, 2, 3, 0]]] == np.asarray(jidx).tolist()


# -------------------------------------------------------------------- MLA
def _mla_params(rng, d, H, m):
    """An MLA layer's parameters (float32 numpy), scales as ``mla_init``,
    norm scales away from 1 so that they count."""
    qk = m.qk_nope_dim + m.qk_rope_dim
    R = m.kv_lora_rank

    def w(*shape, fan):
        return (rng.standard_normal(shape) / np.sqrt(fan)).astype(np.float32)

    p = {}
    if m.q_lora_rank:
        p["wdq"] = w(d, m.q_lora_rank, fan=d)
        p["q_norm"] = {"scale": (1 + 0.1 * rng.standard_normal(
            m.q_lora_rank)).astype(np.float32)}
        p["wuq"] = w(m.q_lora_rank, H, qk, fan=m.q_lora_rank)
    else:
        p["wq"] = w(d, H, qk, fan=d)
    p.update(wdkv=w(d, R, fan=d), wkr=w(d, m.qk_rope_dim, fan=d),
             wuk=w(R, H, m.qk_nope_dim, fan=R),
             wuv=w(R, H, m.v_head_dim, fan=R),
             wo=w(H, m.v_head_dim, d, fan=H * m.v_head_dim))
    p["kv_norm"] = {"scale": (1 + 0.1 * rng.standard_normal(R)).astype(
        np.float32)}
    return p


MLA_ARCHS = ["minicpm3-4b", "deepseek-v2-lite-16b"]


@pytest.mark.parametrize("arch", MLA_ARCHS)
def test_mla_prefill_and_decode_match_jax_float32(arch):
    """Reduced dims (qk 32 + 16, v 32; minicpm3 with a q LoRA, deepseek
    with full-rank queries): prefill out and cache, then three absorbed
    decode steps writing into that cache."""
    cfg = get_arch(arch).reduced()
    m, H, d = cfg.mla, cfg.n_heads, cfg.d_model
    rng = np.random.default_rng(60)
    p = _mla_params(rng, d, H, m)
    Bn, S, slots = 2, 9, 16
    x = rng.standard_normal((Bn, S, d)).astype(np.float32)
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    tp = _to_torch(p, torch.float32)
    want, want_c = jmla.mla_apply(jp, jnp.asarray(x), m,
                                  rope_theta=cfg.rope_theta,
                                  dtype=jnp.float32)
    got, got_c = mla.mla_apply(tp, torch.from_numpy(x), m,
                               rope_theta=cfg.rope_theta,
                               dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)
    jc, tc = {}, {}
    for name in ("c_kv", "k_rope"):
        np.testing.assert_allclose(got_c[name].numpy(),
                                   np.asarray(want_c[name]), rtol=F32_TOL,
                                   atol=F32_TOL)
        pad = ((0, 0), (0, slots - S), (0, 0))
        jc[name] = jnp.pad(want_c[name], pad)
        tc[name] = torch.from_numpy(np.pad(np.asarray(want_c[name]), pad))
    lengths = np.array([S, S - 3], np.int32)   # rows at different fills
    for step in range(3):
        tok = rng.standard_normal((Bn, d)).astype(np.float32)
        want, jc = jmla.mla_decode(jp, jnp.asarray(tok), jc,
                                   jnp.asarray(lengths), m,
                                   rope_theta=cfg.rope_theta,
                                   dtype=jnp.float32)
        got, tc = mla.mla_decode(tp, torch.from_numpy(tok), tc,
                                 torch.from_numpy(lengths), m,
                                 rope_theta=cfg.rope_theta,
                                 dtype=torch.float32)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=F32_TOL, atol=F32_TOL)
        for name in ("c_kv", "k_rope"):
            np.testing.assert_allclose(tc[name].numpy(),
                                       np.asarray(jc[name]), rtol=F32_TOL,
                                       atol=F32_TOL)
        lengths = lengths + 1


@pytest.mark.parametrize("dims,want", [((96, 64), 128), ((192, 128), 192),
                                       ((48, 32), 64), ((128, 128), 128),
                                       ((40, 24), 40)])
def test_mla_pads_qk_to_a_pair_the_kernel_takes(dims, want):
    """The smallest pair both flash kernels take: the reduced configs'
    qk 48 beside v 32 as (64, 32); a v dim no pair has is left as it
    is."""
    assert mla.padded_qk_dim(*dims) == want


@pytest.mark.parametrize("qk,dv", [(96, 64), (48, 64)])
def test_padded_attention_equals_unpadded_with_the_explicit_scale(qk, dv):
    """minicpm3-4b's qk 96 runs as 128 (and 48 as 64): zero columns add
    nothing to any score, so with the scale of the true width the padded
    attention is the unpadded one.  With the padded width's default scale
    it is not, which is why the layer passes the scale."""
    rng = np.random.default_rng(61)
    q, k = (torch.from_numpy(rng.standard_normal((2, 20, 4, qk),
                                                 dtype=np.float32))
            for _ in range(2))
    v = torch.from_numpy(rng.standard_normal((2, 20, 4, dv),
                                             dtype=np.float32))
    pad = mla.padded_qk_dim(qk, dv) - qk
    assert pad > 0
    qp, kp = (torch.cat([t, t.new_zeros(t.shape[:-1] + (pad,))], -1)
              for t in (q, k))
    want = ops.flash_attention(q, k, v, scale=qk ** -0.5)
    got = ops.flash_attention(qp, kp, v, scale=qk ** -0.5)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)
    default = ops.flash_attention(qp, kp, v)
    assert float((default - want).abs().max()) > 1e-3


def test_mla_layer_at_minicpm3_dims_pads_and_matches_jax():
    """minicpm3-4b's head dims (qk 64 + 32, v 64; 4 heads, narrow d): the
    port pads qk to 128 on its way to the flash op, the JAX package does
    not pad; the outputs agree."""
    full = get_arch("minicpm3-4b")
    cfg = full.reduced(mla=dataclasses.replace(full.mla, kv_lora_rank=64,
                                               q_lora_rank=48))
    assert mla.padded_qk_dim(96, 64) == 128
    rng = np.random.default_rng(62)
    p = _mla_params(rng, cfg.d_model, cfg.n_heads, cfg.mla)
    x = rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    want, _ = jmla.mla_apply(jax.tree_util.tree_map(jnp.asarray, p),
                             jnp.asarray(x), cfg.mla,
                             rope_theta=cfg.rope_theta, dtype=jnp.float32)
    got, _ = mla.mla_apply(_to_torch(p, torch.float32), torch.from_numpy(x),
                           cfg.mla, rope_theta=cfg.rope_theta,
                           dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)
