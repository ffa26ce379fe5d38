"""The port's dry-run on the kernel path (``repro_torch.launch.dryrun``,
the default backend: each kernel's operator, ``torch.ops.repro_torch.*``,
through its fake implementation).

Checked here: a launch's scratch counts toward the peak; cells of each
kind complete on a fake (4, 4) mesh for five reduced archs, each peak at
most the ``ref`` cell's and below it on train and prefill cells with
attention, the flops equal wherever no SSD scan runs (the attention ops
count the plain versions' products); and a ``ref`` record is the one the
dry-run wrote before the kernels were ops (``tests/data/dryrun_torch_ref``,
each cell traced in a fresh process), field for field but the trace's
seconds.
"""

from __future__ import annotations

import json
import signal
from pathlib import Path

import pytest
import torch

from repro_torch import intra_op_threads
from repro_torch.configs import SHAPES, get_arch
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.launch.steps import Struct


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The module's CPU work on one intra-op thread: its small products
    would wake every thread, which under the suite's parallel workers
    makes them many times slower (the rule of ``README.md``'s "Tests on
    the CPU")."""
    with intra_op_threads(1):
        yield


LIMIT = 240
REF_RECORDS = Path(__file__).resolve().parent / "data" / "dryrun_torch_ref"
KERNEL_ARCHS = ("yi-6b", "mamba2-2.7b", "recurrentgemma-2b",
                "deepseek-v2-lite-16b", "whisper-large-v3")
KINDS = ("train_4k", "prefill_32k", "decode_32k")


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


def test_a_launch_scratch_counts_toward_the_peak():
    """Decode attention on the kernel path: the trace holds its output and,
    at the launch, the fp32 split partials its fake implementation
    allocates (planned for 132 SMs), freed when it returns."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import ops

    B, H, KV, S, D = 4, 32, 4, 2048, 128
    with dryrun.fake_world(1):
        mesh = make_test_mesh((1, 1))
        with FakeTensorMode():
            args = dryrun.fake_args(
                [Struct((B, H, D), torch.bfloat16, (None,) * 3),
                 Struct((B, S, KV, D), torch.bfloat16, (None,) * 4),
                 Struct((B, S, KV, D), torch.bfloat16, (None,) * 4),
                 Struct((B,), torch.int32, (None,))], mesh)
            _, trace, _ = dryrun._traced(
                lambda *ts: ops.decode_attention(
                    *(t.to_local() for t in ts)), args, mesh)
            arg_bytes = dryrun._arg_bytes(args)
    n_split, _ = dec.plan(S, D, D, H // KV, B * KV, 132)
    out, part = B * H * D * 2, B * KV * n_split * (H // KV) * (D + 2) * 4
    assert trace.peak == arg_bytes + out + part
    assert trace.live == arg_bytes       # the output was dropped
    assert trace.flops == 2 * B * H * S * 2 * D


def _ref_record(arch: str, shape: str) -> dict:
    return json.loads((REF_RECORDS / "mesh4x4"
                       / f"{arch}__{shape}.json").read_text())


# reduced recurrentgemma-2b's local window (64 slots) holds no prefill of
# 32768 positions: that cell raises on both backends
CELLS = [(arch, shape) for shape in KINDS for arch in KERNEL_ARCHS
         if (arch, shape) != ("recurrentgemma-2b", "prefill_32k")]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_kernel_cells_peak_at_most_the_ref_cells(arch, shape):
    """A reduced cell on the kernel path, traced on a fake (4, 4) mesh,
    against the ``ref`` record of the same cell: the same arguments, a
    peak no higher, and lower on train and prefill cells with attention
    (the plain attention's fp32 scores and probabilities are gone); the
    same flops where no SSD scan runs (whose op counts the kernel's
    padded blocks, not the plain version's einsums)."""
    ref = _ref_record(arch, shape)
    with dryrun.fake_world(16):
        rec = dryrun.trace_step(get_arch(arch).reduced(), SHAPES[shape],
                                make_test_mesh((4, 4)), "kernel",
                                probes=False)
    ma, ref_ma = rec["memory_analysis"], ref["memory_analysis"]
    assert ma["argument_size_in_bytes"] == ref_ma["argument_size_in_bytes"]
    assert ma["output_size_in_bytes"] == ref_ma["output_size_in_bytes"]
    assert ma["peak_bytes"] <= ref_ma["peak_bytes"]
    if arch != "mamba2-2.7b" and not shape.startswith("decode"):
        assert ma["peak_bytes"] < ref_ma["peak_bytes"]
    if arch != "mamba2-2.7b":
        assert rec["cost_analysis"]["flops"] == ref["cost_analysis"]["flops"]
    assert rec["collectives"] == ref["collectives"]


@pytest.mark.parametrize("shape", KINDS)
def test_ref_records_are_the_earlier_ones(tmp_path, shape):
    """``--backend ref`` writes the record the dry-run wrote before the
    kernels were ops, field for field, the trace's seconds aside."""
    rec = dryrun.run_cell("yi-6b", shape, False, tmp_path, verbose=False,
                          reduced=True, mesh_shape=(4, 4), backend="ref")
    want = _ref_record("yi-6b", shape)
    for r in (rec, want):
        r.pop("trace_s")
        for probe in r["probes"].values():
            probe.pop("trace_s")
    assert rec == want
    assert json.loads(dryrun.record_path(tmp_path, "mesh4x4", "yi-6b", shape,
                                         "ref").read_text())["probes"] \
        .keys() == want["probes"].keys()
