"""The port's scenario registry, executor bridge and sweep stack against
the JAX package's, on the CPU.

* Every open-loop scenario, an in-memory trace replay and both closed-loop
  processes (fed one completion sequence) give the reference's arrivals,
  exactly, at seeds 0 and 1; so do ``submission_offsets``,
  ``workload_digest`` and ``_synthetic_shape``.
* The synthetic block (``x = tanh(x @ x) + 0.5 x``, ``reps`` times) in
  eager torch matches the jitted JAX block within 5e-3 abs: the two
  ``linspace`` inputs differ by ~1e-7 and 3-6 saturating steps carry that
  to ~1e-3 (|x| <= 2).
* DES sweeps give the reference's records; ``run_executor_cell`` of both
  packages gives the same record under one fake clock.
* Executor sweeps run on the device they are given, fold it into their
  cache keys, and fan out to spawned workers; DES sweeps never load torch.
"""

import dataclasses
import os
import re
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

import repro.core.distrib as j_distrib
import repro.core.executor as j_executor
import repro.core.scenarios as j_scn
import repro.core.sweep as j_sweep
import repro.core.workload as j_workload
from repro_torch import intra_op_threads
import repro_torch.core.distrib as t_distrib
import repro_torch.core.executor as t_executor
import repro_torch.core.scenarios as t_scn
import repro_torch.core.sweep as t_sweep
import repro_torch.core.workload as t_workload
from repro_torch.benchmarks import executor_policies


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The module's CPU work on one intra-op thread: its small products
    would wake every thread, which under the suite's parallel workers
    makes them many times slower (the rule of ``README.md``'s "Tests on
    the CPU")."""
    with intra_op_threads(1):
        yield


ROOT = Path(__file__).resolve().parent.parent
SEEDS = [0, 1]
OPEN = sorted(n for n in j_scn.open_loop_names() if n != "trace-replay")
CLOSED = sorted(n for n in j_scn.SCENARIOS if n not in j_scn.open_loop_names())
TRACE = {"workloads": [
    {"name": "w0", "arrivals": [{"kernel": "SAD", "time": 0.0},
                                {"kernel": "JPEG-d", "time": 120.0},
                                {"kernel": "AES-e", "time": 40.0}]},
    {"name": "w1", "arrivals": [{"kernel": "HISTO", "time": 5.0, "uid": "h"},
                                {"kernel": "CUTCP", "time": 0.0}]},
]}


def canon(arrivals):
    return [(dataclasses.asdict(a.spec), a.time, a.uid) for a in arrivals]


def canon_workloads(scn):
    return [(name, canon(arrivals)) for name, arrivals in scn.workloads()]


# ------------------------------------------------------------- scenarios
def test_registries_name_the_same_scenarios():
    assert sorted(t_scn.SCENARIOS) == sorted(j_scn.SCENARIOS)
    assert t_scn.open_loop_names() == j_scn.open_loop_names()
    assert OPEN and CLOSED


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", OPEN)
def test_open_loop_workloads_match_reference(name, seed):
    want = canon_workloads(j_scn.make_scenario(name, seed=seed))
    got = canon_workloads(t_scn.make_scenario(name, seed=seed))
    assert got == want and want


@pytest.mark.parametrize("seed", SEEDS)
def test_trace_replay_matches_reference(seed):
    want = canon_workloads(j_scn.TraceReplay(seed=seed, trace=TRACE))
    got = canon_workloads(t_scn.TraceReplay(seed=seed, trace=TRACE))
    assert got == want
    assert [a[2] for a in want[1][1]] == ["CUTCP#1", "h"]


def drive(process, steps=60):
    """Feed one deterministic completion sequence to an arrival process:
    the earliest pending arrival completes next, ``1000 * k`` cycles after
    the later of its arrival and the previous completion."""
    pending, seen, now = list(process.initial()), [], 0.0
    while pending and len(seen) < steps:
        pending.sort(key=lambda a: (a.time, a.uid))
        a = pending.pop(0)
        seen.append((dataclasses.asdict(a.spec), a.time, a.uid))
        now = max(now, a.time) + 1000.0 * len(seen)
        pending.extend(process.on_completion(a.key, now))
    return seen


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", CLOSED)
def test_closed_loop_processes_match_reference(name, seed):
    j, t = (m.make_scenario(name, seed=seed) for m in (j_scn, t_scn))
    assert t.process_params() == j.process_params()
    assert t.process_names() == j.process_names()
    for proc in j.process_names():
        want = drive(j.make_process(proc))
        assert drive(t.make_process(proc)) == want and len(want) > 3


@pytest.mark.parametrize("table", ["ERCBENCH", "PARBOIL2_LIKE"])
def test_synthetic_shapes_match_reference(table):
    specs = getattr(j_workload, table)
    assert [t_scn._synthetic_shape(s) for s in specs.values()] == \
        [j_scn._synthetic_shape(s) for s in specs.values()]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [3, 40])
@pytest.mark.parametrize("name", OPEN)
def test_submission_offsets_match_reference(name, n, seed):
    want = j_scn.submission_offsets(name, n, time_scale=1e-6, seed=seed)
    assert t_scn.submission_offsets(name, n, time_scale=1e-6,
                                    seed=seed) == want
    assert len(want) == n


def test_poisson_offsets_of_the_chip_run():
    """The offsets ``chip_smoke.py``'s scenario serve checks on the card."""
    got = t_scn.submission_offsets("poisson-open", 3, time_scale=1e-6,
                                   seed=0)
    assert [round(x, 4) for x in got] == [0.0, 0.1068, 0.1875]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", OPEN + ["trace-replay"])
def test_workload_digest_matches_reference(name, seed):
    kw = {"trace": TRACE} if name == "trace-replay" else {}
    j = j_scn.make_scenario(name, seed=seed, **kw).workloads()
    t = t_scn.make_scenario(name, seed=seed, **kw).workloads()
    assert [t_scn.workload_digest(a) for _, a in t] == \
        [j_scn.workload_digest(a) for _, a in j]


# ---------------------------------------------------------------- bridge
@pytest.mark.parametrize("dim,reps", [(16, 1), (61, 4), (64, 3), (128, 5),
                                      (128, 6)])
def test_synthetic_block_matches_the_jax_block(dim, reps):
    import torch

    j_step, j_x0 = j_scn._jitted_block(dim, reps)
    want = np.asarray(j_step(j_x0))
    t_step, t_x0 = t_scn._synthetic_block(dim, reps, torch.device("cpu"))
    got = t_step(t_x0).numpy()
    assert got.shape == want.shape == (dim, dim)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-3)


@pytest.mark.parametrize("name", sorted(j_workload.ERCBENCH))
def test_executor_job_matches_reference(name):
    spec = j_workload.ERCBENCH[name]
    want = j_scn.executor_job(j_workload.Arrival(spec, 250.0, uid="u"),
                              n_lanes=3, time_scale=1e-5)
    got = t_scn.executor_job(t_workload.Arrival(
        t_workload.ERCBENCH[name], 250.0, uid="u"), n_lanes=3,
        time_scale=1e-5, device="cpu")
    fields = ("name", "num_blocks", "max_residency", "arrival",
              "est_block_seconds")
    assert [getattr(got, f) for f in fields] == \
        [getattr(want, f) for f in fields]
    assert dataclasses.asdict(got.grid_spec()) == \
        dataclasses.asdict(want.grid_spec())
    got.warmup_fn()
    got.make_block_fn(1)()


def test_executor_workload_keeps_uids_on_the_device():
    arrivals = t_scn.TraceReplay(trace=TRACE).workloads()[0][1]
    pairs = t_scn.executor_workload(arrivals, n_lanes=2, time_scale=1e-5,
                                    device="cpu")
    assert [k for k, _ in pairs] == [a.uid for a in arrivals]
    assert [j.arrival for _, j in pairs] == [a.time * 1e-5 for a in arrivals]


# ----------------------------------------------------------------- sweeps
def _des_spec(sweep, scn, closed):
    if closed:
        return sweep.SweepSpec(
            scenarios=(scn.make_scenario("mgk-closed", n_total=6),
                       scn.make_scenario("think-time", n_rounds=2)),
            policies=("fifo", "srtf"), predictors=(None, "ewma"))
    return sweep.SweepSpec(
        scenarios=(scn.make_scenario("pair-stagger",
                                     names=["SAD", "JPEG-d", "AES-e"]),),
        policies=("fifo", "srtf", "sjf"), seeds=(0, 1))


@pytest.mark.parametrize("closed", [False, True], ids=["open", "closed"])
def test_des_sweep_records_match_reference(closed):
    want = j_sweep.run_sweep(_des_spec(j_sweep, j_scn, closed))
    got = t_sweep.run_sweep(_des_spec(t_sweep, t_scn, closed))
    assert [c.as_dict() for c in got.cells] == \
        [c.as_dict() for c in want.cells]
    assert len(want.cells) == (8 if closed else 36)


def _fake_cell(distrib, executor, scn, block_attr, payload, monkeypatch):
    """``run_executor_cell`` with the executor's clock faked and each
    synthetic block advancing it by a function of its shape."""
    clock = [0.0]
    monkeypatch.setattr(executor, "time", types.SimpleNamespace(
        perf_counter=lambda: clock[0]))

    def fake_block(dim, reps, *device):
        def step(x):
            clock[0] += 1e-6 * dim * reps + 3e-5 * (reps % 2)
            return x
        return step, 0.0

    monkeypatch.setattr(scn, block_attr, fake_block)
    return distrib.run_executor_cell(payload)


@pytest.mark.parametrize("policy", ["fifo", "srtf", "mpmax",
                                    "srtf-adaptive"])
@pytest.mark.parametrize("closed", [False, True], ids=["open", "closed"])
def test_executor_cell_matches_reference_under_a_fake_clock(
        policy, closed, monkeypatch):
    def payload(scn_mod):
        if closed:
            scn = scn_mod.make_scenario("mgk-closed", n_total=5)
            extra = {"closed_loop": True, "scenario_obj": scn,
                     "workload_name": scn.process_names()[0]}
            names = list(scn.mix_specs())
        else:
            arrivals = scn_mod.TraceReplay(trace=TRACE).workloads()[0][1]
            extra = {"arrivals": arrivals}
            names = [a.spec.name for a in arrivals]
        return {"policy": policy, "predictor": "simple-slicing", "n_sm": 3,
                "time_scale": 1e-6, "until": None, "device": "cpu",
                "solo": {n: 1e-3 * (i + 1) for i, n in enumerate(names)},
                **extra}

    want = _fake_cell(j_distrib, j_executor, j_scn, "_jitted_block",
                      payload(j_scn), monkeypatch)
    got = _fake_cell(t_distrib, t_executor, t_scn, "_synthetic_block",
                     payload(t_scn), monkeypatch)
    assert got == want
    assert want["measured"] and not want["unfinished"]
    assert len(want["turnaround"]) == (5 if closed else 3)


def _exec_spec(**kw):
    tiny = {"SAD": t_workload.scaled_spec(t_workload.ERCBENCH["SAD"],
                                          num_blocks=6, mean_t=1500.0),
            "JPEG-d": t_workload.scaled_spec(t_workload.ERCBENCH["JPEG-d"],
                                             num_blocks=4, mean_t=900.0)}
    scn = t_scn.TraceReplay(trace=[{"kernel": "SAD", "time": 0.0},
                                   {"kernel": "JPEG-d", "time": 100.0}],
                            specs=tiny, name="xtiny")
    return t_sweep.SweepSpec(scenarios=(scn,), machine="executor", n_sm=3,
                             **kw)


def test_executor_sweep_runs_on_its_device_and_caches_solos(tmp_path,
                                                            monkeypatch):
    spec = _exec_spec(policies=("fifo", "srtf"), device="cpu")
    first = t_sweep.run_sweep(spec, cache_dir=tmp_path)
    assert first.stats["solo_computed"] == 2
    for cell in first.cells:
        assert cell.measured and cell.window.n_finished == 2
        assert sorted(cell.turnaround) == ["JPEG-d#1", "SAD#0"]

    def boom(payload):
        raise AssertionError("solo re-measured despite a warm cache")

    monkeypatch.setattr(t_sweep, "_measure_executor_solo", boom)
    second = t_sweep.run_sweep(spec, cache_dir=tmp_path)
    assert second.stats["solo_computed"] == 0
    assert len(second.cells) == 2


def test_device_is_part_of_every_executor_key():
    spec = t_workload.ERCBENCH["SAD"]
    cpu = t_sweep._executor_solo_key(spec, 4, 1, "cpu")
    assert cpu != t_sweep._executor_solo_key(spec, 4, 1, "cuda")
    assert t_sweep._executor_solo_key(spec, 4, 1, None) == \
        t_sweep._executor_solo_key(spec, 4, 1, "cuda")
    arrivals = [t_workload.Arrival(spec, 0.0, uid="SAD#0")]
    keys = {dev: t_sweep._cell_key(arrivals, "fifo", "simple-slicing", 0, 4,
                                   None, {"SAD": 1.0}, machine="executor",
                                   nonce="n", time_scale=1e-6, device=dev)
            for dev in ("cpu", "cuda")}
    assert keys["cpu"] != keys["cuda"]
    assert _exec_spec(policies=("fifo",)).device == "cuda"
    with pytest.raises(ValueError, match="no device"):
        t_sweep.SweepSpec(scenarios=("pair-stagger",), policies=("fifo",),
                          device="cpu")


def test_executor_sweep_fans_out_to_spawned_workers(tmp_path):
    result = t_sweep.run_sweep(
        _exec_spec(policies=("fifo", "srtf", "mpmax"), device="cpu"),
        jobs=2, cache_dir=tmp_path)
    assert result.stats["solo_pool_jobs"] == 2
    assert len(result.cells) == 3
    for cell in result.cells:
        assert cell.window.n_finished == 2 and not cell.unfinished


def test_des_sweeps_never_load_torch():
    code = ("import sys\n"
            "from repro_torch.core import sweep\n"
            "r = sweep.run_sweep(sweep.SweepSpec(scenarios=('pair-stagger',"
            "), policies=('fifo',)))\n"
            "assert len(r.cells) == 56, len(r.cells)\n"
            "assert 'torch' not in sys.modules\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_executor_policies_benchmark_on_cpu(tmp_path):
    rows = executor_policies.run(device="cpu", cache_dir=tmp_path)
    names = [name for name, _ in rows]
    assert len(names) == 2 * len(executor_policies.POLICY_NAMES) + 3
    assert "executor.long+short.srtf+ewma" in names
    for name, derived in rows[:-1]:
        assert derived.startswith("stp=") and "nan" not in derived
    assert re.search(r"\b\d+ of 10 cells overlap", rows[-1][1])


@pytest.mark.parametrize("finish,want", [
    ({"long": 4.0, "short": 6.0}, False),
    ({"long": 6.0, "short": 7.0}, True),
    ({"short": 7.0}, True),
], ids=["long-ends-first", "short-arrives-while-long-runs",
        "long-unfinished"])
def test_executor_policies_overlap_reads_arrivals_and_finishes(finish,
                                                                want):
    cell = types.SimpleNamespace(arrival={"short": 5.0, "long": 0.0},
                                 finish=finish)
    assert executor_policies.overlaps(cell) is want
