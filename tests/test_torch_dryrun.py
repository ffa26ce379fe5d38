"""The port's dry-run (``repro_torch.launch.dryrun``) and its roofline.

The dry-run traces a step under a fake process group and
``FakeTensorMode``; its counter sits under DTensor, so it counts each
rank's local ops.  Checked here: a sharded product's per-device flops are
the hand count on local shapes (1/256 of the global count on the 16 x 16
mesh, which a counter at the DTensor level would report); a leaf sharded
16 x 16 puts 1/256 of its bytes into the argument bytes; the whole step's
flops are the probes' times their repeats plus the head's; reduced
dbrx-132b train and decode cells complete on a (4, 4) mesh; the CLI
completes a reduced cell of each kind on the production mesh, on the
kernel path by default and on the ``ref`` one under ``<out>/ref/``; the
cell order under ``--scenario`` is the reference's; the roofline reads a
record.
The kernel path's own checks are in ``test_torch_dryrun_kernel.py``.
"""

from __future__ import annotations

import ast
import json
import signal
from pathlib import Path

import pytest
import torch

from repro_torch import intra_op_threads
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
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


def test_sharded_matmul_counts_local_flops():
    from torch._subclasses.fake_tensor import FakeTensorMode

    M, K, N = 16 * 64, 256, 16 * 32
    with dryrun.fake_world():
        mesh = make_production_mesh(device_type="cpu")
        with FakeTensorMode():
            x, w = dryrun.fake_args(
                [Struct((M, K), torch.bfloat16, ("data", None)),
                 Struct((K, N), torch.bfloat16, (None, "model"))], mesh)
            _, trace, _ = dryrun._traced(lambda a, b: a @ b, (x, w), mesh)
    # rank 0's product: [M/16, K] @ [K, N/16], no collective
    assert trace.flops == 2 * (M // 16) * K * (N // 16)
    assert trace.flops * 256 == 2 * M * K * N
    assert all(v["count"] == 0 for v in trace.collectives.values())


def test_argument_bytes_are_the_local_shard():
    from torch._subclasses.fake_tensor import FakeTensorMode

    shape = (4096, 8192)
    with dryrun.fake_world():
        mesh = make_production_mesh(device_type="cpu")
        with FakeTensorMode():
            args = dryrun.fake_args(
                [Struct(shape, torch.float32, ("data", "model"))], mesh)
            assert dryrun._arg_bytes(args) * 256 == 4 * 4096 * 8192


@pytest.fixture(scope="module")
def yi_train(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    rec = dryrun.run_cell("yi-6b", "train_4k", False, out, verbose=False,
                          reduced=True, mesh_shape=(4, 4))
    return rec, out


def test_step_flops_are_the_probes_and_the_head(yi_train):
    """Eager tracing counts every layer: the step's flops are each unit's
    probe times its repeats plus the head's three products a token (the
    vocabulary-chunked loss's forward and its two gradients; remat's
    recomputation stops before the product, whose inputs it saved)."""
    from repro_torch.configs import get_arch

    rec, _ = yi_train
    cfg = get_arch("yi-6b").reduced()
    assert rec["status"] == "ok"
    probes = sum(p["flops"] * p["repeats"] for p in rec["probes"].values())
    # the full-mesh plan: 256 rows over 16 ranks
    B_l, S = 256 // 16, 4096
    head = 3 * 2 * B_l * (S - 1) * cfg.d_model * cfg.padded_vocab
    flops = rec["cost_analysis"]["flops"]
    assert abs(flops - probes - head) <= 1e-3 * flops


def test_roofline_reads_a_record(yi_train, monkeypatch):
    from repro_torch.benchmarks import roofline_impl

    rec, out = yi_train
    monkeypatch.setattr(roofline_impl, "ART_DIR", Path(out))
    rows = roofline_impl.full_table("mesh4x4")
    assert len(rows) == 1 and rows[0]["status"] == "ok"
    row = rows[0]
    assert row["compute_s"] == rec["cost_analysis"]["flops"] / 989e12
    assert row["memory_s"] == rec["cost_analysis"]["bytes accessed"] / 3.35e12
    coll = {ax: sum(v["bytes"] for v in kinds.values())
            for ax, kinds in rec["collectives_by_axis"].items()}
    # (4, 4): "model" (ranks 1 apart) stays in a node of 8, NVLink;
    # "data" (4 apart) crosses nodes, InfiniBand
    want = coll.get("model", 0) / 450e9 + coll.get("data", 0) / 50e9
    assert row["collective_s"] == pytest.approx(want)
    assert roofline_impl.link_bw(1, 16) == roofline_impl.link_bw(16, 16) \
        == roofline_impl.link_bw(256, 2) == 50e9
    assert row["dominant"] in ("compute", "memory", "collective")


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_reduced_dbrx_cells_complete_on_a_fake_4x4_mesh(tmp_path, shape):
    rec = dryrun.run_cell("dbrx-132b", shape, False, tmp_path, verbose=False,
                          reduced=True, mesh_shape=(4, 4))
    assert rec["status"] == "ok"
    assert rec["cost_analysis"]["flops"] > 0
    assert rec["memory_analysis"]["argument_size_in_bytes"] > 0
    assert rec["memory_analysis"]["peak_bytes"] \
        >= rec["memory_analysis"]["argument_size_in_bytes"]
    assert set(rec["collectives_by_axis"]) <= {"data", "model"}
    assert rec["probes"]["stage0"]["repeats"] >= 1
    saved = json.loads((tmp_path / "mesh4x4"
                        / f"dbrx-132b__{shape}.json").read_text())
    assert saved["cost_analysis"] == rec["cost_analysis"]


def test_cli_completes_a_reduced_cell_of_each_kind(tmp_path):
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        with pytest.raises(SystemExit) as done:
            dryrun.main(["--arch", "yi-6b", "--shape", shape,
                         "--reduced", "--out", str(tmp_path)])
        assert done.value.code == 0
        rec = json.loads((tmp_path / "pod16x16"
                          / f"yi-6b__{shape}.json").read_text())
        assert rec["status"] == "ok" and rec["kind"] == shape.split("_")[0]
        assert rec["mesh_shape"] == [16, 16]
        assert rec["traced"] == dryrun.TRACED["kernel"]
    with pytest.raises(SystemExit) as done:
        dryrun.main(["--arch", "yi-6b", "--shape", "decode_32k", "--reduced",
                     "--backend", "ref", "--out", str(tmp_path)])
    assert done.value.code == 0
    ref = json.loads((tmp_path / "ref" / "pod16x16"
                      / "yi-6b__decode_32k.json").read_text())
    kernel = json.loads((tmp_path / "pod16x16"
                         / "yi-6b__decode_32k.json").read_text())
    assert ref["traced"] == dryrun.TRACED["ref"] != kernel["traced"]
    assert ref["memory_analysis"]["peak_bytes"] \
        > kernel["memory_analysis"]["peak_bytes"]


def _reference_scenario_order():
    """The reference's ``_scenario_order``, taken from its source (the
    module sets XLA_FLAGS for 512 host devices when imported)."""
    from repro.core.scenarios import make_scenario

    src = Path(__file__).resolve().parents[1] / "src/repro/launch/dryrun.py"
    tree = ast.parse(src.read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "_scenario_order")
    scope = {"make_scenario": make_scenario}
    exec(compile(ast.Module([fn], []), str(src), "exec"), scope)
    return scope["_scenario_order"]


@pytest.mark.parametrize("scenario,seed", [("poisson-open", 0),
                                           ("poisson-open", 7),
                                           ("bursty", 3)])
def test_scenario_order_is_the_references(scenario, seed):
    from repro_torch.configs import ARCHS
    from repro_torch.configs.shapes import SHAPE_ORDER

    cells = [(a, s) for a in sorted(ARCHS) for s in SHAPE_ORDER]
    want = _reference_scenario_order()(cells, scenario, seed)
    assert dryrun._scenario_order(cells, scenario, seed) == want


def test_test_mesh_is_named_and_sized():
    with dryrun.fake_world(8):
        mesh = make_test_mesh((4, 2))
        assert tuple(mesh.mesh_dim_names) == ("data", "model")
        assert tuple(mesh.shape) == (4, 2)

