"""The sharded steps against the unsharded port, in fp32 on the CPU.

``LocalTensorMode`` simulates every rank of a (2, 2) or (4, 2) ("data",
"model") mesh in this one process, with real values: each DTensor's
shards are held side by side, collectives run on them, and every kernel
call runs once per rank inside ``local_map`` (its plain version, on plain
tensors).  For reduced configs, with B chosen so that each batch plan
runs (the full-mesh batch plan, and the cp / tp plan with the sequence
or the channels on ``model``), the sharded loss, logits and every
gradient leaf, and prefill plus decode logits, match the unsharded port
on the same weights: loss and logits within 1e-5 relative L2 (fp32 sums
in another order), each gradient leaf within 1e-4.  The same bounds hold
the train step of ``build_train_step`` with a mesh (AdamW's update and
state) to the unsharded step.  Also: the log-sum-exp combine of a
sequence-sharded decode cache (slices of local length 0 included), and a
one-rank gloo mesh, which runs the same ops as one device and must give
the same bits.

This file holds yi-6b's cases and the helpers; minicpm3-4b and
whisper-large-v3 run in ``test_torch_sharded_attention.py``, the
recurrent and MoE archs in ``test_torch_sharded_recurrent.py`` and
``test_torch_sharded_moe.py``, so that the driver's workers share them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import signal

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch import intra_op_threads
from repro_torch.configs import get_arch
from repro_torch.configs.shapes import InputShape
from repro_torch.launch import steps
from repro_torch.launch.mesh import batch_axes_of, make_test_mesh
from repro_torch.models import lm
from repro_torch.models.bridge import params_from_numpy
from repro_torch.optim import adamw
from repro_torch.sharding import Sharder, profile_for
from repro_torch.sharding.specs import placements
from repro_torch.tree import leaves, leaves_with_path, tree_map


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The module's CPU work on one intra-op thread: its small products
    would wake every thread, which under the suite's parallel workers
    makes them many times slower (the rule of ``README.md``'s "Tests on
    the CPU")."""
    with intra_op_threads(1):
        yield


#: Seconds a test of these files may take (SIGALRM fails it past that).
LIMIT = 300
LOSS_TOL = 1e-5       # loss and logits, relative L2
GRAD_TOL = 1e-4       # each gradient leaf, relative L2
#: Leaves whose gradient is zero in exact arithmetic (whisper's key
#: biases of unmasked, rope-less attention): absolute noise bound.
NOISE_LEAVES = ("mixer/bk", "cross/bk")
NOISE_TOL = 1e-6
F32 = torch.float32
DECODE_STEPS = 2


@pytest.fixture(autouse=True)
def time_limit():
    """One time limit per test."""
    def expire(signum, frame):
        raise TimeoutError(f"test ran past {LIMIT} s")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(LIMIT)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


@contextlib.contextmanager
def simulated(shape):
    """(LocalTensorMode, mesh) over ``prod(shape)`` simulated ranks."""
    from torch.distributed._local_tensor import LocalTensorMode
    from torch.testing._internal.distributed.fake_pg import FakeStore

    n = math.prod(shape)
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        with LocalTensorMode(n) as mode:
            yield mode, make_test_mesh(shape)
    finally:
        dist.destroy_process_group()


def local(mode, tree):
    """Each leaf as a LocalTensor of per-rank copies (a plain tensor made
    outside the mode would be one storage shared by every rank; one made
    inside it is a LocalTensor already)."""
    from torch.distributed._local_tensor import LocalTensor

    def one(t):
        if isinstance(t, LocalTensor):
            return t
        return mode.rank_map(lambda r: t.detach().clone()) \
            .requires_grad_(t.requires_grad)

    return tree_map(one, tree)


def placed(mode, t, mesh, pl):
    """``t`` as a DTensor placed ``pl`` (redistributed if it is one)."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    if isinstance(t, DTensor):
        return t.redistribute(mesh, pl)
    return distribute_tensor(local(mode, t), mesh, pl)


def rank0(t) -> torch.Tensor:
    from torch.distributed._local_tensor import LocalTensor
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        t = t.full_tensor()
    return t._local_tensors[0] if isinstance(t, LocalTensor) else t


def rel(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm().clamp(min=1e-30))


def reduced(arch: str):
    cfg = get_arch(arch).reduced()
    if cfg.moe is not None:   # nothing dropped: both MoE paths agree
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=16.0))
    return cfg


def weights(cfg, seed: int = 0):
    """fp32 stacked weights from a numpy generator, the init's scales."""
    rng = np.random.default_rng(seed)
    flat = {}
    for path, (shape, how) in lm.param_shapes(cfg).items():
        if isinstance(how, str):
            flat[path] = lm._fixed_init(how, shape[-1]).expand(shape) \
                .numpy().copy()
        else:
            flat[path] = (rng.standard_normal(shape) * how).astype(np.float32)
    params = params_from_numpy(cfg, flat, device="cpu", dtype=F32,
                               stacked=True)
    for _, t in leaves_with_path(params):
        t.requires_grad_()
    return params


def batch_of(cfg, B: int, S: int, seed: int = 1):
    rng = np.random.default_rng(seed)
    n_text = S - (cfg.n_patches or 0)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (B, n_text))).long()}
    if cfg.n_patches:
        batch["patches"] = torch.from_numpy((0.02 * rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model))).astype(np.float32))
    if cfg.encoder is not None:
        batch["frames"] = torch.from_numpy((0.02 * rng.standard_normal(
            (B, cfg.encoder.n_frames, cfg.d_model))).astype(np.float32))
    return batch


def run(cfg, params, batch, S: int, shard=None, mesh=None, mode=None):
    """(loss, grads, logits, [prefill logits, decode logits...])."""
    kw = {} if shard is None else {"shard": shard}
    extra = dict(patches=batch.get("patches"), enc_frames=batch.get("frames"))
    ctx = contextlib.nullcontext()
    if mesh is not None:
        from torch.distributed.tensor.experimental import implicit_replication

        ctx = implicit_replication()
    with ctx:
        loss, _ = lm.loss_fn(cfg, params, batch, dtype=F32, **kw)
        grads = torch.autograd.grad(loss, leaves(params))
        logits, _ = lm.forward(cfg, params, batch["tokens"], dtype=F32,
                               **extra, **kw)
        served = []
        with torch.no_grad():
            out, caches = lm.prefill(cfg, params, batch["tokens"],
                                     max_seq=S + 8, dtype=F32, **extra, **kw)
            served.append(out)
            B = batch["tokens"].shape[0]
            lengths = torch.full((B,), S, dtype=torch.int32)
            tok = batch["tokens"][:, -1]
            for i in range(DECODE_STEPS):
                n = lengths + i
                if mesh is not None:
                    pl = placements(steps.token_spec(B, mesh), mesh)
                    tok, n = (placed(mode, t, mesh, pl) for t in (tok, n))
                out, caches = lm.decode_step(cfg, params, tok, caches, n,
                                             dtype=F32, **kw)
                served.append(out)
                tok = rank0(out).argmax(-1)
    return loss, grads, logits, served


def check_arch(arch: str, mesh_shape, B: int, S: int, plan: str) -> None:
    """The sharded loss, gradients, logits, prefill and decode of the
    reduced ``arch`` against the unsharded port (see the module
    docstring); ``plan`` names the batch plan B must select."""
    cfg = reduced(arch)
    params, batch = weights(cfg), batch_of(cfg, B, S)
    want = run(cfg, params, batch, S)
    with simulated(mesh_shape) as (mode, mesh):
        shard = Sharder(mesh, profile_for(cfg), batch_axes_of(mesh),
                        full_dp=cfg.moe is None)
        axes, model_free = shard._plan(B)
        assert plan == ("full" if not model_free else shard.profile), \
            (axes, model_free)
        sp = steps.place(local(mode, params), mesh)
        sb = steps.place(local(mode, batch), mesh,
                         steps.batch_specs(cfg, batch, mesh))
        got = run(cfg, sp, sb, S, shard, mesh, mode)
        loss, grads, logits, served = (rank0(got[0]),
                                       [rank0(g) for g in got[1]],
                                       rank0(got[2]),
                                       [rank0(t) for t in got[3]])
    assert rel(loss, want[0].detach()) <= LOSS_TOL
    assert rel(logits, want[2].detach()) <= LOSS_TOL
    for (path, _), g, w in zip(leaves_with_path(params), grads, want[1]):
        if path.endswith(NOISE_LEAVES) and cfg.encoder is not None:
            assert float((g - w).abs().max()) <= NOISE_TOL, path
        else:
            assert rel(g, w) <= GRAD_TOL, (path, rel(g, w))
    for i, (g, w) in enumerate(zip(served, want[3])):
        assert rel(g, w) <= LOSS_TOL, ("prefill" if i == 0 else f"decode {i}")


ATTENTION_CASES = [
    ("yi-6b", (2, 2), 2, "cp"), ("yi-6b", (4, 2), 8, "full"),
]


@pytest.mark.parametrize("arch,mesh_shape,B,plan", ATTENTION_CASES)
def test_sharded_steps_match_the_unsharded_port(arch, mesh_shape, B, plan):
    check_arch(arch, mesh_shape, B, 16, plan)


def test_sharded_train_step_matches_the_unsharded_step(monkeypatch):
    """``build_train_step`` with a mesh, two microbatches (each rank's
    local rows split), AdamW: updated params, moments and metrics."""
    monkeypatch.setattr(steps.lm, "loss_fn",
                        functools.partial(lm.loss_fn, dtype=F32))
    cfg = reduced("yi-6b")
    B, S = 8, 16
    shape = InputShape("t", S, B, "train")
    opt = adamw.OptConfig(lr=1e-3, warmup_steps=1)
    params, batch = weights(cfg), batch_of(cfg, B, S)

    def copy(tree):
        return tree_map(lambda t: t.detach().clone().requires_grad_(), tree)

    want_p, want_s, want_m = steps.build_train_step(
        cfg, shape, opt_cfg=opt, microbatches=2).fn(
            copy(params), adamw.init(params), batch)
    with simulated((2, 2)) as (mode, mesh):
        sp = steps.place(local(mode, copy(params)), mesh)
        sb = steps.place(local(mode, batch), mesh,
                         steps.batch_specs(cfg, batch, mesh))
        bundle = steps.build_step(cfg, shape, mesh=mesh, opt_cfg=opt,
                                  microbatches=2)
        got_p, got_s, got_m = bundle.fn(sp, adamw.init(sp), sb)
        got_p = {p: rank0(t) for p, t in leaves_with_path(got_p)}
        got_mom = {p: rank0(t) for p, t in leaves_with_path(got_s["m"])}
        got_m = {k: rank0(v) for k, v in got_m.items()}
    assert rel(got_m["grad_norm"], want_m["grad_norm"]) <= LOSS_TOL
    assert float(got_m["lr"]) == float(want_m["lr"])
    for path, t in leaves_with_path(want_p):
        assert rel(got_p[path], t.detach()) <= GRAD_TOL, path
    for path, t in leaves_with_path(want_s["m"]):
        assert rel(got_mom[path], t) <= GRAD_TOL, path


@pytest.mark.parametrize("window,lengths", [
    (0, [1, 3, 9, 15]),          # rows whose later slices hold no key
    (8, [2, 8, 13, 20]),         # a ring of 8 slots, some wrapped
])
def test_decode_slices_combine_to_unsharded_decode(window, lengths):
    """The token write and the decode over a cache sequence-sharded four
    ways, each slice at its local length (0 for slices past the row's
    length, their lse -inf), combined by log-sum-exp: the unsharded
    write and decode."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.kernels import ops
    from repro_torch.sharding import calls

    rng = np.random.default_rng(5)
    B, S, KV, H, D = 4, window or 16, 2, 4, 8

    def arr(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    q, kn, vn = arr(B, H, D), arr(B, KV, D), arr(B, KV, D)
    kc, vc = arr(B, S, KV, D), arr(B, S, KV, D)
    length = torch.tensor(lengths, dtype=torch.int32)
    ring = bool(window)
    slot = (length % window if ring else length).long()
    wk, wv = kc.clone(), vc.clone()
    wk[torch.arange(B), slot] = kn
    wv[torch.arange(B), slot] = vn
    eff = torch.clamp(length + 1, max=S).to(torch.int32)
    want = ops.decode_attention(q, wk, wv, eff)
    with simulated((1, 4)) as (mode, mesh):
        shard = Sharder(mesh, "cp", batch_axes_of(mesh))
        row = [Replicate(), Replicate()]
        seq = [Replicate(), Shard(1)]
        tk, tv = (distribute_tensor(local(mode, t), mesh, seq)
                  for t in (kc, vc))
        calls.write_token(shard, tk, distribute_tensor(local(mode, kn), mesh,
                                                        row), slot)
        calls.write_token(shard, tv, distribute_tensor(local(mode, vn), mesh,
                                                        row), slot)
        got = calls.decode_attention(
            shard, distribute_tensor(local(mode, q), mesh, row), tk, tv,
            distribute_tensor(local(mode, length), mesh, [Replicate()] * 2),
            window=window)
        got, k_full = rank0(got), rank0(tk)
    assert torch.equal(k_full, wk)
    assert rel(got, want) <= LOSS_TOL


def test_one_rank_mesh_runs_the_same_ops_bitwise():
    """On a (1, 1) mesh of one gloo rank (the card's sharded phase, on the
    CPU) the sharded prefill and decode steps give the unsharded steps'
    bits, and the train step the same AdamW state."""
    from torch.distributed.tensor import distribute_tensor

    cfg = reduced("yi-6b")
    B, S = 2, 16
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_test_mesh((1, 1))
        params = lm.init(cfg, seed=0, device="cpu", stacked=True)
        batch = {"tokens": batch_of(cfg, B, S)["tokens"]}
        pre = InputShape("p", S + 8, B, "prefill")
        dec = InputShape("d", S + 8, B, "decode")
        outs = []
        for m in (None, mesh):
            p = params if m is None else steps.place(params, m)
            b = batch if m is None else steps.place(
                batch, m, steps.batch_specs(cfg, batch, m))
            logits, caches = steps.build_step(cfg, pre, mesh=m).fn(p, b)
            got = [rank0(logits)]
            n = torch.full((B,), S, dtype=torch.int32)
            tok = batch["tokens"][:, -1]
            if m is not None:
                pl = placements(steps.token_spec(B, m), m)
                n, tok = distribute_tensor(n, m, pl), \
                    distribute_tensor(tok, m, pl)
            logits, caches = steps.build_step(cfg, dec, mesh=m).fn(
                p, tok, caches, n)
            outs.append(got + [rank0(logits)])
        for a, b in zip(*outs):
            assert torch.equal(a, b)

        shape = InputShape("t", S, B, "train")
        fp32 = lm.init(cfg, seed=0, device="cpu", dtype=F32, stacked=True)
        states = []
        for m in (None, mesh):
            p = tree_map(lambda t: t.detach().clone().requires_grad_(), fp32)
            p = p if m is None else steps.place(p, m)
            b = batch if m is None else steps.place(
                batch, m, steps.batch_specs(cfg, batch, m))
            _, st, met = steps.build_step(cfg, shape, mesh=m).fn(
                p, adamw.init(p), b)
            states.append([rank0(t) for t in leaves(st["m"])]
                          + [rank0(met["nll"])])
        for a, b in zip(*states):
            assert torch.equal(a, b)
    finally:
        dist.destroy_process_group()


def test_kernel_wrappers_refuse_distributed_tensors():
    """A DTensor or a LocalTensor never reaches a ctypes launch: the CUDA
    wrappers raise TypeError before anything else, and the ops refuse a
    DTensor (under a mesh the kernels run inside local_map)."""
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    with simulated((1, 2)) as (mode, mesh):
        q = torch.zeros(1, 64, 2, 64)
        lt = mode.rank_map(lambda r: q.clone())
        dq = distribute_tensor(lt, mesh, [Replicate(), Replicate()])
        for t in (lt, dq):
            with pytest.raises(TypeError, match="plain"):
                flash_attention_cuda(t, t, t)
        with pytest.raises(TypeError, match="plain"):
            decode_attention_cuda(lt[:, 0], lt, lt,
                                  torch.ones(1, dtype=torch.int32))
        with pytest.raises(TypeError, match="local_map"):
            ops.flash_attention(dq, dq, dq)
