"""The port's threefry streams (``repro_torch.prng``, the plain version of
the ``threefry`` kernel) against ``jax.random`` on the CPU, and the seeded
weights, batches, tokens and prompts built on them against the JAX
package's.

Keys, ``split``, ``fold_in`` (hashed in Python integers), raw bits,
uniforms and ``randint`` (on the CPU, also through the jobs' ``device``
argument) are bitwise.  A float32 normal goes through XLA's ``erf_inv``,
whose ``log1p`` is XLA's own: the port's ``torch.log1p`` differs from it
by an ulp or two in ~8% of draws, which moves ~1% of normals by at most
:data:`NORMAL_ULPS` ulps (3 observed).  A bf16 normal rounds those away.
Weight leaves are normals times a float32 scale (or divided by one), so
they keep the same bound.  The fixed leaves (norm scales, Mamba-2's
``a_log``, RG-LRU's ``a_param``) are bitwise: the port computes
``jnp.linspace``, ``log`` and ``expm1`` in XLA's CPU float32 arithmetic
(``repro_torch.xla_f32``), checked here at every width of ROADMAP's C6.
"""

import dataclasses
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
from jax._src import prng as jprng
import pytest
import torch

from repro.checkpoint.checkpointer import _flatten
from repro.configs import ARCHS
from repro.configs import get_arch as j_get_arch
from repro.configs.shapes import InputShape as JInputShape
from repro.data import pipeline as jdata
from repro.launch import steps as jsteps
from repro.launch.steps import build_train_step as j_build_train_step
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro_torch import intra_op_threads, prng, tree, xla_f32
from repro_torch.configs import get_arch
from repro_torch.configs.shapes import InputShape
from repro_torch.core import jobs
from repro_torch.data import pipeline as data
from repro_torch.examples import quickstart
from repro_torch.kernels import threefry
from repro_torch.launch import steps as tsteps
from repro_torch.launch.steps import build_train_step
from repro_torch.models import lm
from repro_torch.optim import adamw


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The module's CPU work on one intra-op thread: its small products
    would wake every thread, which under the suite's parallel workers
    makes them many times slower (the rule of ``README.md``'s "Tests on
    the CPU")."""
    with intra_op_threads(1):
        yield


#: float32 normals (and weight leaves): at most this many ulps from the
#: reference's.
NORMAL_ULPS = 4
#: Share of float32 normals that must be bitwise (99.0% observed).
NORMAL_BITWISE = 0.98
#: The fixed leaves' widths: Mamba-2's heads and the RG-LRU's width,
#: full and reduced, and the widths between (ROADMAP C6).
C6_SIZES = (8, 16, 24, 32, 48, 64, 80, 128, 2560)
#: Keys whose words sit at the ends of uint32.
EDGE_KEYS = ((0, 0), (0, 1), (1, 0), (0, 2 ** 32 - 1), (2 ** 32 - 1, 0),
             (2 ** 32 - 2, 2 ** 32 - 1), (2 ** 32 - 1, 2 ** 32 - 1))
#: bf16 models (the serve job's prefill): the bound of test_torch_model.
BF16_REL_L2 = 3e-2
_SANITIZE = re.compile(r"[^A-Za-z0-9_.:-]")
MASK = 0xFFFFFFFF


def _jkey(words) -> jax.Array:
    return jnp.asarray(np.asarray(words, np.uint32))


def _keys(n: int, seed: int = 0) -> list:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 2 ** 32, 2, dtype=np.uint64).astype(np.int64)
            for _ in range(n)]


def _ulps(want: np.ndarray, got: np.ndarray) -> np.ndarray:
    """Distance in float32 ulps (both finite, same sign or near zero)."""
    a = np.asarray(want, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(got, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def _bf16_ulps(want: np.ndarray, got: np.ndarray) -> np.ndarray:
    return _ulps(want, got) >> 16


# ------------------------------------------------------------------ keys
@pytest.mark.parametrize("seed", [0, 7, 2 ** 33 + 5, -1, 2 ** 31 + 1])
def test_key_is_prngkey(seed):
    np.testing.assert_array_equal(prng.key(seed).numpy(),
                                  np.asarray(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("num", [2, 3, 6, 8, 27])
def test_split_is_bitwise(num):
    for k in _keys(3, num):
        np.testing.assert_array_equal(
            prng.split(torch.from_numpy(k), num).numpy(),
            np.asarray(jax.random.split(_jkey(k), num)))


@pytest.mark.parametrize("data_", [0, 1, 99, 4095, 2 ** 31 + 3])
def test_fold_in_is_bitwise(data_):
    for k in _keys(3, data_ % 97):
        np.testing.assert_array_equal(
            prng.fold_in(torch.from_numpy(k), data_).numpy(),
            np.asarray(jax.random.fold_in(_jkey(k), data_)))


@pytest.mark.parametrize("num", [1, 2, 4, 7, 16, 64])
def test_split_at_the_word_edges(num):
    """The key tree's Python-integer hash at keys near 0 and near
    2**32 - 1."""
    for k in EDGE_KEYS:
        np.testing.assert_array_equal(
            prng.split(torch.tensor(k), num).numpy(),
            np.asarray(jax.random.split(_jkey(k), num)))


@pytest.mark.parametrize("data_", [0, 1, 63, 2 ** 31, 2 ** 32 - 1])
def test_fold_in_at_the_word_edges(data_):
    for k in EDGE_KEYS:
        np.testing.assert_array_equal(
            prng.fold_in(torch.tensor(k), data_).numpy(),
            np.asarray(jax.random.fold_in(_jkey(k), data_)))


def test_hash_words_is_the_tensor_hash_and_jaxs():
    """One counter pair through ``hash_words`` (ints), the int32 tensor
    hash and jax's ``threefry2x32``."""
    rng = np.random.default_rng(13)
    pairs = np.concatenate([rng.integers(0, 2 ** 32, (40, 4),
                                         dtype=np.uint64),
                            np.array([[0, 0, 0, 0], [MASK] * 4,
                                      [MASK, 0, MASK, 0]], np.uint64)])
    for k0, k1, x0, x1 in pairs.tolist():
        o0, o1 = jprng.threefry2x32_p.bind(
            *(jnp.asarray(np.uint32(v))[None] for v in (k0, k1, x0, x1)))
        want = (int(np.asarray(o0)[0]), int(np.asarray(o1)[0]))
        assert prng.hash_words(k0, k1, x0, x1) == want
        got = prng.threefry2x32(k0, k1, x0, torch.tensor(
            [x1 - 2 ** 32 if x1 >> 31 else x1], dtype=torch.int32))
        assert int(got) & MASK == want[0] ^ want[1]


@pytest.mark.parametrize("width,dtype", [(32, jnp.uint32), (16, jnp.uint16),
                                         (8, jnp.uint8)])
def test_bits_are_bitwise(width, dtype):
    for shape, k in zip([(37, 41), (5, 3, 7), (1,)], _keys(3, width)):
        got = prng.bits(torch.from_numpy(k), shape, width).numpy()
        want = np.asarray(jax.random.bits(_jkey(k), shape, dtype))
        np.testing.assert_array_equal(got, want.astype(np.int64))


# ------------------------------------------------------------- uniforms
@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (1e-6, 1.0), (-3.0, 0.5)])
def test_fp32_uniform_is_bitwise(lo, hi):
    k = _keys(1, 5)[0]
    got = prng.uniform(torch.from_numpy(k), (64000,), torch.float32, lo, hi)
    want = jax.random.uniform(_jkey(k), (64000,), jnp.float32, lo, hi)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_bf16_uniform_is_bitwise():
    k = _keys(1, 6)[0]
    got = prng.uniform(torch.from_numpy(k), (20000,), torch.bfloat16)
    want = jax.random.uniform(_jkey(k), (20000,), jnp.bfloat16)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


_VOCABS = sorted({get_arch(a).vocab_size for a in ARCHS}
                 | {get_arch(a).reduced().vocab_size for a in ARCHS})


@pytest.mark.parametrize("vocab", _VOCABS)
def test_randint_is_bitwise_at_every_vocabulary(vocab):
    k = _keys(1, vocab % 1009)[0]
    got = prng.randint(torch.from_numpy(k), (4, 999), 0, vocab)
    want = jax.random.randint(_jkey(k), (4, 999), 0, vocab)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -------------------------------------------------------------- normals
def test_fp32_normal_within_ulps(capsys):
    k = _keys(1, 8)[0]
    got = prng.normal(torch.from_numpy(k), (200000,)).numpy()
    want = np.asarray(jax.random.normal(_jkey(k), (200000,)))
    ulps = _ulps(want, got)
    share = float((ulps == 0).mean())
    with capsys.disabled():
        print(f"\n[prng] fp32 normals: {share:.4%} bitwise, at most "
              f"{ulps.max()} ulps apart")
    assert ulps.max() <= NORMAL_ULPS
    assert share >= NORMAL_BITWISE


def test_xla_erfinv_edges():
    x = torch.tensor([-1.0, 1.0, 0.0, 0.5, -0.9999999])
    got = prng.erfinv(x).numpy()
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(x.numpy())))
    assert np.isinf(got[:2]).all() and (np.sign(got[:2]) == [-1, 1]).all()
    assert (_ulps(want[2:], got[2:]) <= NORMAL_ULPS).all()


def test_bf16_normal_within_one_ulp():
    k = _keys(1, 9)[0]
    got = prng.normal(torch.from_numpy(k), (100000,), torch.bfloat16)
    want = jax.random.normal(_jkey(k), (100000,), jnp.bfloat16)
    assert _bf16_ulps(np.asarray(want, np.float32),
                      got.float().numpy()).max() <= 1


# --------------------------------------------------------- chunked draws
@pytest.mark.parametrize("dist", ["bits", "uniform", "normal"])
def test_a_chunked_draw_equals_the_whole_draw(dist, monkeypatch):
    k = torch.from_numpy(_keys(1, 10)[0])
    kw = dict(lo=1e-6, hi=1.0) if dist == "uniform" else {}
    dtype = torch.int32 if dist == "bits" else torch.float32
    whole = threefry.draw(torch.empty(5000, dtype=dtype), k, dist, **kw)
    parts = torch.cat([
        threefry.draw(torch.empty(n, dtype=dtype), k, dist, offset=o, **kw)
        for o, n in [(0, 1234), (1234, 1), (1235, 3765)]])
    torch.testing.assert_close(parts, whole, rtol=0, atol=0)
    monkeypatch.setattr(threefry, "CHUNK", 777)      # the plain op's chunks
    chunked = threefry.draw(torch.empty(5000, dtype=dtype), k, dist, **kw)
    torch.testing.assert_close(chunked, whole, rtol=0, atol=0)


def test_counters_past_two_to_the_32():
    """The counter's hi word: elements past 2**32 of a stream."""
    k = torch.from_numpy(_keys(1, 11)[0])
    off = 2 ** 32 - 3
    got = prng.bits(k, 6, offset=off).numpy()
    hi, lo = np.array([0, 0, 0, 1, 1, 1]), np.array([2 ** 32 - 3, 2 ** 32 - 2,
                                                     2 ** 32 - 1, 0, 1, 2])
    o0, o1 = jprng.threefry2x32_p.bind(
        *_jkey(k), jnp.asarray(hi, jnp.uint32), jnp.asarray(lo, jnp.uint32))
    np.testing.assert_array_equal(got, (np.asarray(o0) ^ np.asarray(o1))
                                  .astype(np.int64))


def test_kernel_op_plain_implementation_runs_on_cpu():
    """The op's CPU implementation (what ``opcheck`` calls) is the plain
    version, writing into its argument."""
    k = torch.from_numpy(_keys(1, 12)[0])
    out = torch.empty((3, 50), dtype=torch.bfloat16)
    torch.ops.repro_torch.threefry(out, *threefry._op_args(
        k, "normal", 0.0, 1.0, 0.02, False, True, 0))
    want = threefry.threefry_plain(k, 150, "normal", scale=0.02,
                                   bf16_math=True)
    torch.testing.assert_close(out.view(-1).float(), want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        threefry.threefry_cuda(out, k)


# --------------------------------------------------------------- weights
def _sanitized(tree_) -> dict:
    return {_SANITIZE.sub("_", p): v for p, v in tree.leaves_with_path(tree_)}


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_init_is_the_references_leaf_for_leaf(arch):
    """Every leaf of the port's ``init(seed=s)`` (fp32, stacked) against
    the reference's ``init(cfg, PRNGKey(s))`` for two seeds: normals
    within NORMAL_ULPS, fixed leaves bitwise."""
    cfg, tcfg = j_get_arch(arch).reduced(), get_arch(arch).reduced()
    draws = lm.draw_keys(tcfg)
    for seed in (0, 3):
        want = {k: np.asarray(v, np.float32) for k, v in
                _flatten(jlm.init(cfg, jax.random.PRNGKey(seed))).items()}
        got = _sanitized(lm.init(tcfg, seed=seed, device="cpu",
                                 dtype=torch.float32, stacked=True))
        assert sorted(got) == sorted(want)
        for path, w in want.items():
            g = got[path].numpy()
            assert g.shape == w.shape, path
            if path in {_SANITIZE.sub("_", p) for p in draws}:
                assert _ulps(w, g).max() <= NORMAL_ULPS, path
            else:
                np.testing.assert_array_equal(g, w, err_msg=path)


def test_serving_init_rounds_the_references_leaves_to_bf16():
    cfg, tcfg = j_get_arch("yi-6b").reduced(), get_arch("yi-6b").reduced()
    want = {k: np.asarray(jnp.asarray(v).astype(jnp.bfloat16), np.float32)
            for k, v in _flatten(jlm.init(cfg, jax.random.PRNGKey(2))).items()}
    params = lm.init(tcfg, seed=2, device="cpu")
    for r, layer in enumerate(params["stage0"]["u0"]):
        for name in ("wq", "wk", "wv", "wo"):
            g = layer["mixer"][name]
            assert g.dtype == torch.bfloat16
            assert _bf16_ulps(want[f"stage0_u0_mixer_{name}"][r],
                              g.float().numpy()).max() <= 1
    assert _bf16_ulps(want["embed_table"],
                      params["embed"]["table"].float().numpy()).max() <= 1


# ----------------------------------------------------------------- data
@pytest.mark.parametrize("arch", ["yi-6b", "pixtral-12b", "whisper-large-v3"])
def test_batch_for_step_is_the_references(arch):
    cfg, tcfg = j_get_arch(arch).reduced(), get_arch(arch).reduced()
    for seed, step in [(0, 0), (5, 3)]:
        want = jdata.batch_for_step(cfg, JInputShape("t", 64, 4, "train"),
                                    step, jdata.DataConfig(seed=seed))
        got = data.batch_for_step(tcfg, InputShape("t", 64, 4, "train"),
                                  step, data.DataConfig(seed=seed))
        assert sorted(got) == sorted(want)
        np.testing.assert_array_equal(got["tokens"].numpy(),
                                      np.asarray(want["tokens"]))
        for k in set(want) - {"tokens"}:
            assert got[k].dtype == torch.bfloat16
            np.testing.assert_array_equal(got[k].float().numpy(),
                                          np.asarray(want[k], np.float32))


def test_tokens_of_many_uniforms(capsys):
    """The tokens' power: float64 rounded to float32 against XLA's float32
    pow, over 2M uniforms.  The uniforms are bitwise; a token differs only
    where the two powers straddle an integer: at most 2 in a million (2
    of these 2M draws do)."""
    key, n = jax.random.PRNGKey(4), 2_000_000
    want = np.asarray(jdata._tokens(key, (n,), 256000, 1.1))
    u = prng.uniform(prng.key(4), (n,), torch.float32, 1e-6, 1.0)
    np.testing.assert_array_equal(
        u.numpy(), np.asarray(jax.random.uniform(key, (n,), jnp.float32,
                                                 1e-6, 1.0)))
    differ = int((data._tokens(u, 256000, 1.1).numpy() != want).sum())
    with capsys.disabled():
        print(f"\n[prng] {differ} of {n} tokens differ from the reference's")
    assert differ <= 2 * n // 1_000_000


@pytest.mark.parametrize("seed,block", [(0, 0), (3, 7)])
def test_job_tokens_and_prompts_are_the_references(seed, block):
    cfg = get_arch("yi-6b").reduced()
    want = jax.random.randint(
        jax.random.fold_in(jax.random.PRNGKey(seed + 1), block), (2, 32), 0,
        cfg.vocab_size)
    np.testing.assert_array_equal(
        jobs.train_tokens(cfg, seed, block, 2, 32).numpy(), np.asarray(want))
    want = jax.random.randint(jax.random.PRNGKey(seed), (2, 16), 0,
                              cfg.vocab_size)
    np.testing.assert_array_equal(jobs.serve_prompt(cfg, seed, 2, 16).numpy(),
                                  np.asarray(want))


@pytest.mark.parametrize("device", ["cpu", torch.device("cpu")])
def test_tokens_and_prompts_drawn_on_the_jobs_device(device):
    """``train_tokens`` / ``serve_prompt`` with a device, and
    ``threefry.randint`` (the plain version through the op's ``bits``
    draws on the CPU), against ``jax.random.randint`` (at the shape the
    test above compiles)."""
    cfg = get_arch("deepseek-v2-lite-16b").reduced()
    want = jax.random.randint(jax.random.fold_in(jax.random.PRNGKey(5), 9),
                              (2, 32), 0, cfg.vocab_size)
    got = jobs.train_tokens(cfg, 4, 9, 2, 32, device=device)
    assert got.dtype == torch.int64 and got.device == torch.device("cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = jax.random.randint(jax.random.PRNGKey(6), (2, 32), 0,
                              cfg.vocab_size)
    np.testing.assert_array_equal(
        jobs.serve_prompt(cfg, 6, 2, 32, device=device).numpy(),
        np.asarray(want))
    k = torch.from_numpy(_keys(1, 15)[0])
    np.testing.assert_array_equal(
        threefry.randint(k, (2, 32), -3, 1000, device=device).numpy(),
        np.asarray(jax.random.randint(_jkey(k), (2, 32), -3, 1000)))


# --------------------------------------------------------- fixed leaves
@pytest.mark.parametrize("n", C6_SIZES)
@pytest.mark.parametrize("how", ["a_log", "a_param"])
def test_fixed_leaf_is_the_references_bitwise(how, n):
    """``lm._fixed_init`` against the reference's formulas
    (``repro.models.ssm.mamba2_init``'s ``a_log``,
    ``repro.models.rglru.rglru_block_init``'s ``a_param``)."""
    if how == "a_log":
        want = jnp.log(jnp.linspace(1.0, 16.0, n))
    else:
        want = jnp.log(jnp.expm1(-jnp.log(jnp.linspace(0.9, 0.999, n))))
    np.testing.assert_array_equal(lm._fixed_init(how, n).numpy(),
                                  np.asarray(want))


@pytest.mark.parametrize("n", C6_SIZES)
@pytest.mark.parametrize("fn", ["linspace", "log", "expm1"])
def test_xla_f32_function_is_jaxs_bitwise(fn, n):
    """Each function of ``repro_torch.xla_f32`` on its own: linspace over
    both leaves' ranges, log and expm1 over their ranges there and over
    ``n`` uniforms from ``default_rng(n)``."""
    if fn == "linspace":
        for lo, hi in ((1.0, 16.0), (0.9, 0.999)):
            np.testing.assert_array_equal(
                xla_f32.linspace(lo, hi, n).numpy(),
                np.asarray(jnp.linspace(lo, hi, n)))
        return
    rng = np.random.default_rng(n)
    if fn == "log":
        x = np.concatenate([np.asarray(jnp.linspace(1.0, 16.0, n)),
                            rng.uniform(1e-3, 20.0, 8 * n)])
    else:
        x = np.concatenate([-np.log(np.asarray(jnp.linspace(0.9, 0.999, n),
                                               np.float64)),
                            rng.uniform(-3.0, 3.0, 8 * n)])
    x = x.astype(np.float32)
    np.testing.assert_array_equal(
        getattr(xla_f32, fn)(torch.from_numpy(x)).numpy(),
        np.asarray(getattr(jnp, fn)(x)))


# ------------------------------------------------------- the slice whole
def test_quickstart_steps_from_the_ports_own_init_and_data(monkeypatch):
    """The quickstart's three steps with the port's own ``init`` and
    ``batch_for_step`` (no bridge, no shared numpy inputs) against the
    reference's from ``PRNGKey(0)`` and its own batches, both losses in
    float32: nll within 1e-4 relative (test_torch_examples' bound)."""
    steps = 3
    monkeypatch.setattr(jsteps.lm, "loss_fn", functools.partial(
        jlm.loss_fn, dtype=jnp.float32))
    monkeypatch.setattr(tsteps.lm, "loss_fn", functools.partial(
        lm.loss_fn, dtype=torch.float32))
    cfg = j_get_arch("yi-6b").reduced()
    tcfg = get_arch("yi-6b").reduced()
    shape = JInputShape(**dataclasses.asdict(quickstart.SHAPE))
    opt = quickstart.opt_config(steps)
    bundle = j_build_train_step(cfg, shape, mesh=None, remat=False,
                                opt_cfg=jadamw.OptConfig(
                                    lr=opt.lr, warmup_steps=opt.warmup_steps,
                                    total_steps=opt.total_steps))
    jp = jlm.init(cfg, jax.random.PRNGKey(0))
    js, want = jadamw.init(jp), []
    for s in range(steps):
        jp, js, m = bundle.fn(jp, js, jdata.batch_for_step(cfg, shape, s))
        want.append(float(m["nll"]))

    tp = lm.init(tcfg, seed=0, device="cpu", dtype=torch.float32,
                 stacked=True)
    for p in tree.leaves(tp):
        p.requires_grad_()
    tbundle = build_train_step(tcfg, quickstart.SHAPE, mesh=None,
                               remat=False, opt_cfg=opt)
    run = quickstart.run_steps(
        tbundle, tp, adamw.init(tp),
        (data.batch_for_step(tcfg, quickstart.SHAPE, s)
         for s in range(steps)), steps, torch.device("cpu"))
    np.testing.assert_allclose(run["nll"], want, rtol=1e-4)


@pytest.mark.parametrize("arch", ["yi-6b", "mamba2-2.7b"])
def test_serve_job_prompt_and_prefill_are_the_references(arch):
    """A reduced serve job's seeded prompt (bitwise) and the prefill
    logits of its seeded bf16 weights, both packages on their own draws."""
    cfg, tcfg = j_get_arch(arch).reduced(), get_arch(arch).reduced()
    seed, batch, prompt_len, max_seq = 1, 2, 16, 32
    key = jax.random.PRNGKey(seed)
    jprompt = jax.random.randint(key, (batch, prompt_len), 0, cfg.vocab_size)
    prompt = jobs.serve_prompt(tcfg, seed, batch, prompt_len)
    np.testing.assert_array_equal(prompt.numpy(), np.asarray(jprompt))
    want, _ = jlm.prefill(cfg, jlm.init(cfg, key), jprompt, max_seq=max_seq)
    got, _ = lm.prefill(tcfg, lm.init(tcfg, seed=seed, device="cpu"),
                        prompt, max_seq=max_seq)
    w, g = np.asarray(want, np.float32), got.float().numpy()
    rel = np.linalg.norm(g - w, axis=-1) / np.linalg.norm(w, axis=-1)
    assert rel.max() < BF16_REL_L2, rel
