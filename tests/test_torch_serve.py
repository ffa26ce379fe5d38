"""The port's serving path and scheduler copy, on the CPU.

* Serving jobs of reduced yi-6b, a mix of reduced mamba2-2.7b and
  recurrentgemma-2b, and one of reduced minicpm3-4b (MLA) and
  deepseek-v2-lite-16b (MLA + MoE), run through the port's
  SchedulerService under srtf and fifo, and through ``python -m
  repro_torch.launch.serve``, whose default mix is the JAX package's.
* ``--scenario`` paces submissions at the reference's offsets, and
  ``--scenario-kernels`` serves the scenario's own arrivals as synthetic
  jobs whose solo baselines a second run reads from the sweep cache.
* The port's copies of the scheduler, DES and sweep modules are held to
  the JAX package's: the files are identical (save comment lines reworded
  to name no project history, the executor bridge of ``scenarios.py``,
  and in ``sweep``/``distrib``/``launch.worker`` the lines that thread
  the device or name the port's modules), and both ``LaneExecutor``s
  produce the same trace and results for the same jobs under one fake
  clock.
* The port imports neither JAX nor the JAX package, names none of its
  modules, and its entry points refuse to run without a card unless
  asked for the CPU.
"""

import ast
import difflib
import os
import re
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

import repro.core.executor as j_executor
from repro.core.executor import ExecutorJob as JJob, LaneExecutor as JLane
from repro.core.policies import POLICIES, make_policy as j_make_policy
from repro.core.scenarios import submission_offsets as j_offsets
from repro_torch import intra_op_threads
from repro_torch.configs import get_arch
from repro_torch.core import executor as t_executor
from repro_torch.core.executor import ExecutorJob as TJob, LaneExecutor as TLane
from repro_torch.core.jobs import make_serve_job
from repro_torch.core import scenarios as t_scenarios, sweep as t_sweep
from repro_torch.core.policies import make_policy as t_make_policy
from repro_torch.core.scheduler_service import SchedulerService
from repro_torch.core.sweep import SweepSpec
from repro_torch.examples import concurrent_serving
from repro_torch.launch import serve
from repro_torch.models import lm


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The module's CPU work on one intra-op thread: its small products
    would wake every thread, which under the suite's parallel workers
    makes them many times slower (the rule of ``README.md``'s "Tests on
    the CPU")."""
    with intra_op_threads(1):
        yield


ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
COPIED = ["configs/" + p.name for p in sorted(
    (ROOT / "src" / "repro" / "configs").glob("*.py"))] + [
    f"core/{m}.py" for m in ("workload", "events", "predictor", "machine",
                             "policies", "executor", "metrics",
                             "scheduler_service", "simulator",
                             "fastsim_twin", "fastsim_c", "fastsim")]
#: Comment lines the port's copies reword so that no program file names a
#: project's change or issue numbers: {file: {reference line: port line}}.
REWORDED = {
    "core/fastsim.py": {
        "    default (ISSUE 7: import must never hard-require numba).":
        "    default (import must never hard-require numba).",
    },
    "core/fastsim_twin.py": {
        "  fallback the ISSUE requires when numba is absent,":
        "  fallback that must exist when numba is absent,",
    },
    "core/sweep.py": {
        "  Records are byte-identical across dispatchers (the PR-5/7 gate);":
        "  Records are byte-identical across dispatchers (a tested gate);",
        "#: Since PR 9 the three tables are identical: distrib.py — the cell":
        "#: The three tables are identical: distrib.py — the cell",
        "    ``jobs > 1`` before PR 9 — pure fixed cost at the head of every "
        "cold":
        "    ``jobs > 1`` once — pure fixed cost at the head of every cold",
    },
}
#: Faults of the reference's code that the port's copy fixes (ROADMAP.md
#: C): {file: [(reference lines, port lines)]}, each reference block
#: found once and replaced whole.
FIXED = {
    "core/executor.py": [(
        ["        healthy = sum(1 for ln in self.sms if not ln.failed)",
         "        candidates = sorted(",
         "            ((ew, idx) for idx, ew in self.lane_t_ewma.items()",
         "             if not self.sms[idx].failed"],
        ["        healthy = sum(1 for ln in self.sms if not ln.failed)",
         "        # Nor the lane a sampling policy samples on (SRTF's "
         "sample_sm):",
         "        # quarantined, it could never issue a sample, and the jobs",
         "        # waiting for their predictions would strand the same way."
         "  Its",
         "        # first blocks (a serve job's prefill) run long by design.",
         "        sample_lane = getattr(self.core.policy, \"sample_sm\", "
         "None)",
         "        candidates = sorted(",
         "            ((ew, idx) for idx, ew in self.lane_t_ewma.items()",
         "             if not self.sms[idx].failed and idx != sample_lane"]),
    ],
}
#: Copies whose changed lines must each thread the device or name the
#: port's modules (blank lines aside).
DEVICE_THREADED = ["core/sweep.py", "core/distrib.py", "launch/worker.py"]


def _reference_lines(rel):
    """The reference's lines with the port's rewordings applied."""
    lines = (ROOT / "src" / "repro" / rel).read_text().splitlines()
    reworded = REWORDED.get(rel, {})
    assert all(lines.count(old) == 1 for old in reworded), rel
    lines = [reworded.get(line, line) for line in lines]
    for old, new in FIXED.get(rel, []):
        at = [i for i in range(len(lines))
              if lines[i:i + len(old)] == old]
        assert len(at) == 1, (rel, old)
        lines[at[0]:at[0] + len(old)] = new
    return lines


# ------------------------------------------------------------- serving
@pytest.mark.parametrize("policy", ["srtf", "fifo"])
def test_serve_jobs_finish_through_the_service(policy):
    cfg = get_arch("yi-6b").reduced()
    blocks = {"long": 4, "short": 2}
    with SchedulerService(n_lanes=2, policy=policy) as service:
        handles = {
            name: service.submit(make_serve_job(
                cfg, name, blocks=n, tokens_per_block=2, batch=1,
                prompt_len=8, seed=i, device="cpu"))
            for i, (name, n) in enumerate(sorted(blocks.items()))}
        results = {name: h.result_blocking(timeout=120)
                   for name, h in handles.items()}
    for name, res in results.items():
        assert res.blocks == blocks[name] and not res.cancelled


def test_serve_job_takes_a_given_prompt_and_keeps_state_through_warmup():
    cfg = get_arch("yi-6b").reduced()
    prompt = torch.arange(16).reshape(2, 8) % cfg.vocab_size
    job = make_serve_job(cfg, "p", blocks=1, tokens_per_block=1, batch=2,
                         prompt_len=8, prompt=prompt.numpy(), device="cpu")
    job.warmup_fn()
    job.make_block_fn(1)()
    with pytest.raises(ValueError, match="prompt shape"):
        make_serve_job(cfg, "p", blocks=1, batch=1, prompt_len=8,
                       prompt=prompt, device="cpu")


@pytest.mark.parametrize("extra,blocks", [
    ([], [2, 3]),
    (["--closed-loop", "2", "--requests", "3"], [2, 3, 3]),
], ids=["open-loop", "closed-loop"])
def test_serve_cli_reduced_on_cpu(extra, blocks, capsys):
    runs = serve.main(["--device", "cpu", "--reduced",
                       "--jobs", "yi-6b:3,yi-6b:2", "--policy", "srtf",
                       "--compare-fifo", "--tokens-per-block", "2",
                       "--prompt-len", "8", "--batch", "1", "--lanes", "2",
                       "--stagger", "0"] + extra)
    assert sorted(runs) == ["fifo", "srtf"]
    for run in runs.values():
        assert run["peak_bytes"] is None
        assert sorted(r.blocks for r in run["results"]) == blocks
    assert "srtf vs fifo" in capsys.readouterr().out


def test_serve_cli_mixes_recurrent_archs_on_cpu(capsys):
    """The mixed tenants of the chip run, reduced: a pure-SSM model and the
    RG-LRU / local-attention hybrid share the service."""
    runs = serve.main(["--device", "cpu", "--reduced",
                       "--jobs", "mamba2-2.7b:3,recurrentgemma-2b:2",
                       "--policy", "srtf", "--compare-fifo",
                       "--tokens-per-block", "4", "--prompt-len", "8",
                       "--batch", "2", "--lanes", "2", "--stagger", "0"])
    assert sorted(runs) == ["fifo", "srtf"]
    for run in runs.values():
        assert sorted((r.key.split("#")[0], r.blocks, r.cancelled)
                      for r in run["results"]) == [
            ("mamba2-2.7b", 3, False), ("recurrentgemma-2b", 2, False)]
    out = capsys.readouterr().out
    assert "tenant=mamba2-2.7b" in out and "tenant=recurrentgemma-2b" in out


def test_serve_cli_mixes_mla_and_moe_archs_on_cpu(capsys):
    """The MLA / MoE tenants of the chip run, reduced."""
    runs = serve.main(["--device", "cpu", "--reduced",
                       "--jobs", "minicpm3-4b:4,deepseek-v2-lite-16b:2",
                       "--policy", "srtf", "--compare-fifo",
                       "--tokens-per-block", "4", "--prompt-len", "8",
                       "--batch", "1", "--lanes", "2", "--stagger", "0"])
    for run in runs.values():
        assert sorted((r.key.split("#")[0], r.blocks, r.cancelled)
                      for r in run["results"]) == [
            ("deepseek-v2-lite-16b", 2, False), ("minicpm3-4b", 4, False)]
    out = capsys.readouterr().out
    assert "tenant=minicpm3-4b" in out and "tenant=deepseek-v2-lite-16b" in out


def test_serve_default_mix_is_the_references():
    """``--jobs`` defaults to ``repro.launch.serve``'s mix,
    ``yi-6b:24,minicpm3-4b:6`` (read from its source, which builds its
    parser inside ``main``), and that mix runs, reduced, on the CPU."""
    tree = ast.parse((ROOT / "src" / "repro" / "launch" / "serve.py")
                     .read_text())
    want = next(kw.value.value for node in ast.walk(tree)
                if isinstance(node, ast.Call) and node.args
                and isinstance(node.args[0], ast.Constant)
                and node.args[0].value == "--jobs"
                for kw in node.keywords if kw.arg == "default")
    assert want == "yi-6b:24,minicpm3-4b:6"
    assert serve.build_parser().get_default("jobs") == want
    runs = serve.main(["--device", "cpu", "--reduced", "--policy", "fifo",
                       "--tokens-per-block", "1", "--prompt-len", "4",
                       "--batch", "1", "--stagger", "0"])
    assert sorted(r.blocks for r in runs["fifo"]["results"]) == [6, 24]


def test_serve_job_refuses_to_outgrow_the_local_window():
    cfg = get_arch("recurrentgemma-2b").reduced()
    job = make_serve_job(cfg, "long", blocks=20, tokens_per_block=4,
                         batch=1, prompt_len=8, device="cpu")
    with pytest.raises(ValueError, match="window"):
        job.warmup_fn()


def _scenario_args(*extra):
    return ["--device", "cpu", "--reduced", "--policy", "srtf",
            "--compare-fifo", "--tokens-per-block", "2", "--prompt-len", "8",
            "--batch", "1", "--lanes", "2"] + list(extra)


def test_serve_scenario_submits_at_the_references_offsets(capsys):
    argv = _scenario_args("--jobs", "yi-6b:3,minicpm3-4b:2,yi-6b:3",
                          "--scenario", "poisson-open", "--time-scale",
                          "1e-7", "--seed", "1")
    want = j_offsets("poisson-open", 3, time_scale=1e-7, seed=1)
    args = serve.build_parser().parse_args(argv)
    assert serve.submission_schedule(args) == want
    assert [p[0] for p in serve.submission_plan(
        args, {("yi-6b", 3): 1.0, ("minicpm3-4b", 2): 1.0})] == want
    runs = serve.main(argv)
    for run in runs.values():
        assert sorted((r.key.split("#")[0], r.blocks, r.cancelled)
                      for r in run["results"]) == [
            ("minicpm3-4b", 2, False), ("yi-6b", 3, False),
            ("yi-6b", 3, False)]
    assert "srtf vs fifo" in capsys.readouterr().out


def test_serve_scenario_kernels_cache_their_solos(tmp_path, monkeypatch):
    """The scenario's own arrivals run as synthetic jobs on the CPU; their
    solo baselines land in the sweep cache and a second run reads them."""
    measured = []
    real = t_sweep._measure_executor_solo
    monkeypatch.setattr(t_sweep, "_measure_executor_solo",
                        lambda payload: measured.append(payload) or
                        real(payload))
    argv = _scenario_args("--scenario", "poisson-open", "--scenario-kernels",
                          "--max-blocks", "3", "--cache-dir", str(tmp_path))
    arrivals = serve.scenario_arrivals(serve.build_parser().parse_args(argv))
    specs = {a.spec for a in arrivals}
    for rerun in (False, True):
        runs = serve.main(argv)
        for run in runs.values():
            assert sorted(r.key for r in run["results"]) == \
                sorted(a.uid for a in arrivals)
            assert all(r.blocks == min(3, a.spec.num_blocks) and
                       not r.cancelled
                       for r, a in zip(sorted(run["results"],
                                              key=lambda r: r.key),
                                       sorted(arrivals,
                                              key=lambda a: a.uid)))
        assert len(measured) == len(specs)
        assert {p["device"] for p in measured} == {"cpu"}
        assert len(list(tmp_path.rglob("*.json"))) == len(specs)


def test_serve_scenario_kernels_close_the_loop(tmp_path):
    runs = serve.main(_scenario_args(
        "--scenario", "bursty", "--scenario-kernels", "--max-blocks", "2",
        "--cache-dir", str(tmp_path), "--closed-loop", "2", "--requests",
        "5"))
    for run in runs.values():
        assert len(run["results"]) == 5
        assert not any(r.cancelled for r in run["results"])


def test_serve_scenario_kernels_need_a_scenario(capsys):
    with pytest.raises(SystemExit):
        serve.main(_scenario_args("--scenario-kernels"))
    assert "--scenario-kernels requires --scenario" in capsys.readouterr().err


# ------------------------------------------------- scheduler-copy parity
JOBS = [
    # (name, blocks, max_residency, arrival s, block seconds)
    ("a", 7, 2, 0.0, 0.30),
    ("b", 3, 4, 0.05, 0.10),
    ("c", 5, 1, 0.40, 0.20),
    ("d", 2, 3, 0.45, 0.70),
]


def _drive(job_cls, lane_cls, make_policy, module, predictor, policy,
           monkeypatch):
    clock = [0.0]
    monkeypatch.setattr(module, "time",
                        types.SimpleNamespace(perf_counter=lambda: clock[0]))

    def job(name, blocks, res, arrival, secs):
        calls = [0]

        def make_block_fn(residency):
            def block():
                calls[0] += 1
                # deterministic, slightly uneven block times
                clock[0] += secs * (1.0 + 0.1 * (calls[0] % 3))
            return block
        return job_cls(name=name, num_blocks=blocks, max_residency=res,
                       make_block_fn=make_block_fn, arrival=arrival,
                       est_block_seconds=secs)

    ex = lane_cls([job(*spec) for spec in JOBS], make_policy(policy),
                  n_lanes=4, predictor=predictor)
    results = ex.run()
    return ex.trace, {k: (r.arrival, r.finish, r.blocks, r.cancelled)
                      for k, r in sorted(results.items())}


@pytest.mark.parametrize("predictor", ["simple-slicing", "ewma"])
@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_scheduler_copy_matches_reference(policy, predictor, monkeypatch):
    want = _drive(JJob, JLane, j_make_policy, j_executor, predictor, policy,
                  monkeypatch)
    got = _drive(TJob, TLane, t_make_policy, t_executor, predictor, policy,
                 monkeypatch)
    assert got == want
    assert len(want[0]) == sum(spec[1] for spec in JOBS)


@pytest.mark.parametrize("rel", COPIED)
def test_copied_module_is_identical_to_reference(rel):
    ref = ROOT / "src" / "repro" / rel
    if rel not in REWORDED and rel not in FIXED:
        assert (PORT / rel).read_bytes() == ref.read_bytes()
    assert (PORT / rel).read_text().splitlines() == _reference_lines(rel)


def test_scenarios_copy_differs_only_in_its_executor_bridge():
    """Lines 1-1033 and 1126-1199 of the reference are the port's, byte for
    byte; only the executor bridge between them is rewritten."""
    ref = (ROOT / "src" / "repro" / "core" / "scenarios.py").read_text() \
        .splitlines(keepends=True)
    port = (PORT / "core" / "scenarios.py").read_text() \
        .splitlines(keepends=True)
    start = next(i for i, line in enumerate(ref)
                 if line.startswith("# ---") and "executor bridge" in line)
    end = next(i for i, line in enumerate(ref)
               if line.startswith("# ---") and "utilities" in line)
    assert (start, end, len(ref)) == (1033, 1125, 1199)
    p_start, p_end = port.index(ref[start]), port.index(ref[end])
    assert port[:p_start] == ref[:start] and port[p_end:] == ref[end:]
    bridge = "".join(port[p_start:p_end])
    assert "jax" not in bridge and "torch.cuda.synchronize" in bridge


@pytest.mark.parametrize("side", ["reference", "port"])
def test_srtf_sampling_lane_is_never_quarantined(side):
    """The reference's straggler quarantine can take lane 0, where SRTF
    samples, out of service; the jobs then waiting for a sample never run
    (the serving run awaits them forever).  Lane 0 is made slow here, as a
    serve job's first blocks (its prefill) make it: the reference's
    executor strands three of four jobs, the port's finishes them all
    (``FIXED``; ROADMAP.md C)."""
    job, lane, policy = ((JJob, JLane, j_make_policy) if side == "reference"
                         else (TJob, TLane, t_make_policy))
    jobs = [job(name=f"j{i}", num_blocks=n, max_residency=4,
                make_block_fn=lambda residency: (lambda: None))
            for i, n in enumerate((40, 6, 6, 6))]
    ex = lane(jobs, policy("srtf"), n_lanes=4, straggler=(0, 1000.0))
    finished = sorted(k for k, r in ex.run().items() if r.blocks)
    if side == "reference":
        assert finished == ["j0#0"] and ex.sms[0].failed
    else:
        assert finished == ["j0#0", "j1#1", "j2#2", "j3#3"]
        assert not ex.sms[0].failed


@pytest.mark.parametrize("rel", DEVICE_THREADED)
def test_device_threaded_copy_differs_only_in_device_lines(rel):
    ref = _reference_lines(rel)
    port = (PORT / rel).read_text().splitlines()
    changed = 0
    for op, i1, i2, j1, j2 in difflib.SequenceMatcher(
            None, ref, port, autojunk=False).get_opcodes():
        if op == "equal":
            continue
        assert op in ("insert", "replace"), (op, ref[i1:i2])
        if op == "replace":
            assert i2 - i1 == j2 - j1, (ref[i1:i2], port[j1:j2])
        for line in port[j1:j2]:
            assert not line.strip() or "device" in line \
                or "repro_torch" in line, line
            changed += 1
    assert changed > 0


# ------------------------------------------------------ package boundary
def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


#: Top-level packages the port may not import: JAX, the JAX package and the
#: reference's benchmarks and examples (run from the repo root, a copy that
#: imported them would test the reference instead of the port).
REFERENCE_PACKAGES = ("jax", "jaxlib", "repro", "benchmarks", "examples")
#: A string shaped like a module path of the reference's packages.
REFERENCE_MODULE = re.compile(r"^(repro|benchmarks|examples)(\.\w+)+$")


def _reference_imports(paths) -> list:
    bad = []
    for path in paths:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                if name.split(".")[0] in REFERENCE_PACKAGES:
                    bad.append(f"{os.path.relpath(path, ROOT)}:{node.lineno}"
                               f" imports {name}")
    return bad


def _reference_module_names(paths) -> list:
    return [f"{os.path.relpath(path, ROOT)}:{node.lineno} {node.value!r}"
            for path in paths
            for node in ast.walk(ast.parse(path.read_text()))
            if isinstance(node, ast.Constant) and isinstance(node.value, str)
            and REFERENCE_MODULE.match(node.value)]


def test_port_imports_neither_jax_nor_the_jax_package():
    bad = _reference_imports(_port_files())
    assert not bad, bad
    assert len(_port_files()) > 20


def test_port_names_no_module_of_the_jax_package():
    """No string constant of the port is shaped like a module path of the
    JAX package or of the reference's ``benchmarks`` and ``examples`` (a
    ``-m`` argument, an ``importlib`` target): spawned workers or the
    benchmark driver would silently run the reference."""
    bad = _reference_module_names(_port_files())
    assert not bad, bad


@pytest.mark.parametrize("line,refused_by", [
    ("import benchmarks.common", _reference_imports),
    ("from benchmarks import common", _reference_imports),
    ("from examples.cluster_sim import main", _reference_imports),
    ("import jax.numpy as jnp", _reference_imports),
    ("from repro.core import sweep", _reference_imports),
    ("MODULE = 'benchmarks.fig01_fifo_luck'", _reference_module_names),
    ("MODULE = 'examples.cluster_sim'", _reference_module_names),
    ("MODULE = 'repro.core.sweep'", _reference_module_names),
], ids=lambda v: v if isinstance(v, str) else v.__name__)
def test_package_guards_refuse_the_references_modules(line, refused_by,
                                                      tmp_path):
    """Each guard flags such a line in a scratch file, and neither flags
    the port's own modules beside it."""
    scratch = tmp_path / "scratch.py"
    scratch.write_text("from .common import sweep\n"
                       "from repro_torch.benchmarks import run\n"
                       "OWN = 'repro_torch.benchmarks.fig01_fifo_luck'\n"
                       f"{line}\n")
    assert len(refused_by([scratch])) == 1
    other = _reference_module_names if refused_by is _reference_imports \
        else _reference_imports
    assert other([scratch]) == []


def test_entry_points_refuse_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is valid")
    cfg = get_arch("yi-6b").reduced()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lm.init(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_serve_job(cfg, "x", blocks=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--reduced", "--jobs", "yi-6b:1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--scenario", "poisson-open", "--scenario-kernels",
                    "--max-blocks", "1"])
    arrival = t_scenarios.make_scenario("poisson-open").workloads()[0][1][0]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_scenarios.executor_job(arrival)
    spec = SweepSpec(scenarios=(t_scenarios.TraceReplay(
        trace=[{"kernel": "SAD"}]),), policies=("fifo",),
        machine="executor")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_sweep.run_sweep(spec)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        concurrent_serving.main(["--reduced"])


@pytest.mark.parametrize("alone", [False, True], ids=["repo", "alone"])
def test_chip_smoke_fails_without_a_card(alone, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    script = ROOT / "chip_smoke.py"
    if alone:
        (tmp_path / "chip_smoke.py").write_bytes(script.read_bytes())
        script = tmp_path / "chip_smoke.py"
    proc = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
