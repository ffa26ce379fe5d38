"""The port's counterpart of ``jax.jit`` on the serving path, on the CPU.

On the card a serve job captures its decode step once, at warm-up, as a
CUDA graph (``repro_torch.graphs``) and every block replays it.  Without
a card these tests hold what the capture needs and what it runs:

* (a) the decode step a job captures (``jobs.decode_in_place``) traces
  under ``FakeTensorMode`` on the kernel route, as the dry-run traces it,
  for every reduced arch the serving path runs, under a dispatch mode
  that fails on any operation that reads device data on the host (a
  capture refuses them); the guard itself refuses each such operation;
* (b) the step's static buffers (token and lengths advanced in place, the
  caches of the warm-up's prefill, the first block's prefill copied into
  them) over three blocks of a reduced job are bitwise the eager loop the
  job ran before, leave no trace of the warm-up in the states, and give
  the tokens of the reference's jitted ``make_serve_job`` on the same
  weights and prompt;
* the launch counts: a launch made while a thread captures is counted at
  each replay, and only that thread's launches go to its capture.

The card's side (replays bitwise the eager steps, a capture beside
another thread's allocations, the decode counters, counts per replay) is
in ``tests/test_torch_cuda.py``.
"""

import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode

from repro.checkpoint.checkpointer import _flatten
from repro.configs import get_arch as j_get_arch
from repro.core import jobs as j_jobs
from repro.models import lm as jlm
from repro_torch import graphs, intra_op_threads
from repro_torch.configs import get_arch
from repro_torch.core import jobs
from repro_torch.kernels import ops
from repro_torch.models import lm
from repro_torch.models.bridge import params_from_numpy
from repro_torch.tree import leaves, leaves_with_path, tree_map


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The module's CPU work on one intra-op thread: its small products
    would wake every thread, which under the suite's parallel workers
    makes them many times slower (the rule of ``README.md``'s "Tests on
    the CPU")."""
    with intra_op_threads(1):
        yield


#: The archs the serving path runs (chip_smoke's serve paths' families).
SERVE_ARCHS = ["yi-6b", "mamba2-2.7b", "recurrentgemma-2b", "minicpm3-4b",
               "deepseek-v2-lite-16b"]
#: The mixers whose decode goes through the decode-attention kernel.
DECODE_KERNEL_MIXERS = ("gqa", "local")
BATCH, PROMPT, BLOCKS, TOKENS_PER_BLOCK = 2, 8, 3, 2
MAX_SEQ = PROMPT + BLOCKS * TOKENS_PER_BLOCK + 8   # make_serve_job's


class HostRead(AssertionError):
    """An operation read device data on the host."""


#: Index operations that read a boolean or byte mask on the host (its
#: ``nonzero``); with integer indices they stay on the device.
_INDEXING = ("index", "index_put", "index_put_", "_index_put_impl_",
             "_unsafe_index", "_unsafe_index_put")


def reads_host(func, args) -> bool:
    """Whether ``func`` on ``args`` needs device data on the host: a
    scalar read (``_local_scalar_dense``: ``.item()``, ``bool(t)``,
    ``.tolist()``), a data-dependent output (``equal``), an output shape
    that depends on the data (``nonzero``, ``masked_select``, ``unique``,
    ``repeat_interleave`` by a tensor) or indexing by a mask, but for a
    put of one value under one mask (``masked_fill_`` on the device)."""
    name = func.overloadpacket.__name__
    if name in _INDEXING:
        indices = [i for i in args[1] if i is not None]
        if not any(i.dtype in (torch.bool, torch.uint8) for i in indices):
            return False
        return name.startswith("_unsafe_index") and "put" not in name \
            or name == "index" or not (len(indices) == 1
                                       and args[2].numel() == 1)
    return torch.Tag.data_dependent_output in func.tags \
        or torch.Tag.dynamic_output_shape in func.tags


class NoHostReads(TorchDispatchMode):
    """Fails on any operation that reads device data on the host; records
    the names of the operations it let through."""

    def __init__(self):
        super().__init__()
        self.seen = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if reads_host(func, args):
            raise HostRead(f"{func} reads device data on the host")
        self.seen.add(str(func.overloadpacket))
        return func(*args, **(kwargs or {}))


def _decode_kernel_layers(cfg) -> int:
    return sum(spec.mixer in DECODE_KERNEL_MIXERS
               for stage in lm.build_plan(cfg)
               for spec in stage.unit * stage.repeats)


# ------------------------------------------------------ (a) the trace
@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_decode_step_traces_without_reading_the_device_on_the_host(arch):
    """The body a serve job captures, on fake tensors of a prefilled
    reduced job, through the kernels' ops (their fake implementations):
    no operation reads device data on the host, and the step writes the
    argmax into the token and advances the lengths in place."""
    cfg = get_arch(arch).reduced()
    params = lm.init(cfg, seed=0, device="cpu")
    prompt = jobs.serve_prompt(cfg, 0, BATCH, PROMPT)
    step = jobs.DecodeStep(cfg, params, prompt, MAX_SEQ)
    step.prefill()
    with FakeTensorMode() as mode:
        fake = [tree_map(mode.from_tensor, t)
                for t in (params, step.token, step.caches, step.lengths)]
        with NoHostReads() as guard:
            logits = jobs.decode_in_place(cfg, *fake)
        p, token, caches, lengths = fake
        assert isinstance(logits, FakeTensor)
        assert tuple(logits.shape) == (BATCH, cfg.padded_vocab)
        assert token.dtype == torch.long and lengths.dtype == torch.int32
    assert "aten.add_" in guard.seen and "aten.copy_" in guard.seen
    assert "aten._local_scalar_dense" not in guard.seen
    kernel = "repro_torch.decode_attention"
    assert (kernel in guard.seen) == (_decode_kernel_layers(cfg) > 0)


@pytest.mark.parametrize("snippet", [
    "x.sum().item()",
    "bool((x > 0).any())",
    "x.tolist()",
    "x[x > 0]",
    "torch.nonzero(x)",
    "torch.masked_select(x, x > 0)",
    "torch.unique(i)",
    "x.repeat_interleave(i.clamp(min=0), dim=0)",
    "torch.equal(x, x)",
    "x.index_put_((x > 0,), torch.arange(12.0))",
])
def test_the_host_read_guard_refuses_each_host_read(snippet):
    with FakeTensorMode() as mode:
        x = mode.from_tensor(torch.randn(3, 4))
        i = mode.from_tensor(torch.arange(3))
        with pytest.raises(HostRead), NoHostReads():
            eval(snippet, {"torch": torch, "x": x, "i": i})


def test_the_host_read_guard_lets_integer_indexing_through():
    """The decode step's cache writes index by integer tensors: they stay
    on the device and the guard lets them through."""
    with FakeTensorMode() as mode:
        x = mode.from_tensor(torch.zeros(3, 5, 2))
        b = mode.from_tensor(torch.arange(3))
        s = mode.from_tensor(torch.tensor([1, 4, 0]))
        with NoHostReads() as guard:
            x[b, s] = torch.ones(3, 2)
            y = x[b, s]
            x[x > 0] = 0.0                 # masked_fill_ on the device
        assert tuple(y.shape) == (3, 2)
    assert "aten.index_put_" in guard.seen and "aten.index" in guard.seen


# ------------------------------------------------ (b) the static step
def _reference_weights(arch, seed, monkeypatch, dtype=torch.bfloat16):
    """The reference's seeded (float32) weights bridged into the port in
    ``dtype``, the port's ``lm.init`` made to return them.  Returns (the
    reference's config, the port's, the port's weights)."""
    cfg, tcfg = j_get_arch(arch).reduced(), get_arch(arch).reduced()
    flat = _flatten(jlm.init(cfg, jax.random.PRNGKey(seed)))
    monkeypatch.setattr(jobs.lm, "init", lambda c, seed, device: (
        params_from_numpy(c, flat, device=device, dtype=dtype)))
    return cfg, tcfg, params_from_numpy(tcfg, flat, device="cpu",
                                        dtype=dtype)


def _in_float32(arch, seed, monkeypatch):
    """Both packages' prefill and decode step computing in float32, the
    port on the reference's float32 weights."""
    for mod, dtype in ((lm, torch.float32), (jlm, jnp.float32)):
        for name in ("prefill", "decode_step"):
            monkeypatch.setattr(mod, name, functools.partial(
                getattr(mod, name), dtype=dtype))
    return _reference_weights(arch, seed, monkeypatch, torch.float32)


def _reference_block_tokens(cfg, seed):
    """The reference's jitted ``make_serve_job``: its token after each
    block, read from the job's state."""
    job = j_jobs.make_serve_job(cfg, "r", blocks=BLOCKS,
                                tokens_per_block=TOKENS_PER_BLOCK,
                                batch=BATCH, prompt_len=PROMPT, seed=seed)
    job.warmup_fn()
    block = job.make_block_fn(1)
    state = next(c.cell_contents for c in block.__closure__
                 if isinstance(c.cell_contents, dict)
                 and "token" in c.cell_contents)
    out = []
    for _ in range(BLOCKS):
        block()
        out.append(np.asarray(state["token"]))
    return np.stack(out)


def _eager_loop(cfg, params, prompt):
    """The serve job's loop before it kept static buffers: a prefill into
    fresh caches, then each step's argmax fed back with lengths + 1.
    Returns (per step (token, logits), final caches)."""
    logits, caches = lm.prefill(cfg, params, prompt, max_seq=MAX_SEQ)
    lengths = torch.full((BATCH,), PROMPT, dtype=torch.int32)
    token, steps = torch.argmax(logits, -1), []
    for _ in range(BLOCKS * TOKENS_PER_BLOCK):
        logits, caches = lm.decode_step(cfg, params, token, caches, lengths)
        token = torch.argmax(logits, -1)
        lengths = lengths + 1
        steps.append((token, logits))
    return steps, caches


def _run_job(cfg, seed, monkeypatch):
    """A reduced serve job on the CPU, warmed up, then its blocks.
    Returns (per step (token, logits) of the blocks, caches after the
    warm-up, caches at the end)."""
    seen = {"steps": None, "caches": None}
    real = jobs.decode_in_place

    def record(c, p, token, caches, lengths):
        logits = real(c, p, token, caches, lengths)
        if seen["steps"] is not None:
            seen["steps"].append((token.clone(), logits.clone()))
        seen["caches"] = caches
        return logits

    monkeypatch.setattr(jobs, "decode_in_place", record)
    job = jobs.make_serve_job(cfg, "s", blocks=BLOCKS,
                              tokens_per_block=TOKENS_PER_BLOCK,
                              batch=BATCH, prompt_len=PROMPT, seed=seed,
                              device="cpu")
    job.warmup_fn()
    warm = [t.clone() for t in leaves(seen["caches"])]
    block, seen["steps"] = job.make_block_fn(1), []
    for _ in range(BLOCKS):
        block()
    monkeypatch.setattr(jobs, "decode_in_place", real)
    return seen["steps"], warm, seen["caches"]


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_static_step_over_three_blocks_is_the_eager_loop(arch,
                                                         monkeypatch):
    """A reduced serve job on the CPU (warm-up, then three blocks) runs
    the body the card captures on the buffers the card keeps.  In bf16,
    as it serves: every step's token and logits and the final caches are
    bitwise the eager loop's, so the warm-up's step (which advanced the
    recurrent states and wrote keys past the prompt) left nothing behind.
    In float32, each block's last token is the reference's jitted job's
    on the same weights and prompt.  (In bf16 the two packages round
    differently, logits within the parity tests' bf16 bound, and a greedy
    token can flip at a near tie: mamba2-2.7b's second row at this seed,
    its prefill's top two logits one bf16 ulp apart.  The float32 runs
    take the reference's float32 weights, which it casts to bf16 at each
    use in bf16.)"""
    seed = 3
    jcfg, cfg, params = _reference_weights(arch, seed, monkeypatch)
    got, warm, caches = _run_job(cfg, seed, monkeypatch)
    prompt = jobs.serve_prompt(cfg, seed, BATCH, PROMPT)
    want, want_caches = _eager_loop(cfg, params, prompt)
    assert len(got) == len(want) == BLOCKS * TOKENS_PER_BLOCK
    for i, ((tok, logits), (wtok, wlogits)) in enumerate(zip(got, want)):
        assert torch.equal(tok, wtok), i
        assert torch.equal(logits, wlogits), i
    got_caches = dict(leaves_with_path(caches))
    assert list(got_caches) == [p for p, _ in leaves_with_path(want_caches)]
    for path, leaf in leaves_with_path(want_caches):
        assert torch.equal(got_caches[path], leaf), path
    # the warm-up's step did write the caches the first block overwrote
    _, fresh = lm.prefill(cfg, params, prompt, max_seq=MAX_SEQ)
    assert any(not torch.equal(w, t) for w, t in zip(warm, leaves(fresh)))

    _in_float32(arch, seed, monkeypatch)
    got32, _, _ = _run_job(cfg, seed, monkeypatch)
    block_ends = [got32[(b + 1) * TOKENS_PER_BLOCK - 1][0]
                  for b in range(BLOCKS)]
    np.testing.assert_array_equal(
        np.stack([t.numpy() for t in block_ends]),
        _reference_block_tokens(jcfg, seed))


def test_a_serve_job_runs_without_a_warmup_on_the_cpu():
    """Without a warm-up (a caller driving blocks itself) the first
    block's prefill makes the caches the step keeps."""
    cfg = get_arch("mamba2-2.7b").reduced()
    job = jobs.make_serve_job(cfg, "n", blocks=2, tokens_per_block=2,
                              batch=1, prompt_len=PROMPT, device="cpu")
    block = job.make_block_fn(1)
    block()
    block()


# ------------------------------------------------------ launch counts
def test_launches_made_while_capturing_count_at_each_replay():
    """A launch counted inside a capture's record goes to the graph's
    counts, not to the wrapper's; each replay adds them."""
    wrapper = ops.KERNELS["decode_attention"]
    ops.reset_launch_counts()
    graphs.count(wrapper)
    assert wrapper.launches == 1
    kept = torch.zeros(2)
    with graphs._recording() as rec:
        graphs.count(wrapper)
        graphs.count(wrapper)
        graphs.hold(kept)
    assert wrapper.launches == 1
    assert rec.counts == {wrapper: 2} and rec.held == [kept]

    class Replayed:
        runs = 0

        def replay(self):
            Replayed.runs += 1

    g = graphs.Graph(Replayed(), "out", rec.held, rec.counts)
    assert [g.replay() for _ in range(3)] == ["out"] * 3
    assert Replayed.runs == 3 and wrapper.launches == 1 + 3 * 2
    graphs.hold(torch.ones(1))          # outside a capture: nothing kept
    assert rec.held == [kept]
    ops.reset_launch_counts()


def test_a_capture_records_only_its_own_threads_launches():
    """While one thread captures, another thread's launches (a job being
    built beside a serving run's warm-up) count as they happen."""
    wrapper = ops.KERNELS["ssd_scan"]
    ops.reset_launch_counts()
    with graphs._recording() as rec:
        other = threading.Thread(
            target=lambda: [graphs.count(wrapper) for _ in range(5)])
        other.start()
        other.join()
        graphs.count(wrapper)
    assert wrapper.launches == 5 and rec.counts == {wrapper: 1}
    ops.reset_launch_counts()


def test_launch_counts_lose_no_update_across_threads():
    """Sixteen threads counting launches and replaying a graph's counts at
    once, switching every microsecond, lose no update."""
    import sys

    wrapper = ops.KERNELS["flash_attention"]

    class Replayed:
        def replay(self):
            pass

    g = graphs.Graph(Replayed(), None, [], {wrapper: 3})
    ops.reset_launch_counts()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=lambda: [
            (graphs.count(wrapper), g.replay()) for _ in range(500)])
            for _ in range(16)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(w.is_alive() for w in workers)
    assert wrapper.launches == 16 * 500 * (1 + 3)
    ops.reset_launch_counts()


def test_capture_needs_a_cuda_device():
    with pytest.raises(ValueError, match="CUDA device"):
        graphs.capture(lambda: None, "cpu")
