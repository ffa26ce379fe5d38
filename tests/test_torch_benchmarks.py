"""The port's paper benchmarks and cluster example against the reference's,
on the CPU.

* Each ported module (``repro_torch.benchmarks.{common,run,fig*,table*,
  scenarios_openloop,closedloop}`` and ``repro_torch.examples.cluster_sim``)
  is the reference's text save its imports, the lines that name
  ``repro_torch`` and the lines listed in ``ADDED`` / ``DROPPED``: the
  executor's device in ``run``, the executor's description in ``common``
  and ``run``, and ``cluster_sim.main``'s ``argv``.
* ``python -m repro_torch.benchmarks.run --machine des --no-cache`` prints
  the rows of the reference's ``benchmarks.run``, name and ``derived``
  (``us_per_call`` dropped), module by module, at full size under the
  compiled engine and at ``--subset 2`` under the python engine, with the
  same engine token in the header.  The roofline rows differ by design (the reference's are
  a TPU's, the port's the H100's) and are left out.
* Table 5's rows do not depend on the dispatcher; the executor rows run on
  the CPU when asked, honour ``--subset``, and fail without a card when not.
* ``python -m repro_torch.examples.cluster_sim`` prints the reference's
  lines.
* ``python -m repro_torch.benchmarks.perf --smoke`` prints the rows of the
  reference's DES perf lane in the same order with the same counts
  (timings, speed-ups and history differ by design), writes
  ``BENCH_des_torch.json`` in its working directory unless told otherwise
  and never the root's ``BENCH_des.json``, pins its baseline only from a
  clean commit, and refuses ``--repeat 0``, ``--jobs 0`` and an unknown
  engine.

Each driver and lane runs in a subprocess of its own (``common`` keeps module-level
configuration and memoises Table 5): the reference's from the repo root,
which puts its ``benchmarks`` package on the path, the port's from a
temporary directory, where no package of the reference can be imported.
"""

import ast
import difflib
import inspect
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import intra_op_threads
from repro_torch.benchmarks import executor_policies, perf
from repro_torch.examples import cluster_sim


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The module's CPU work on one intra-op thread: its small products
    would wake every thread, which under the suite's parallel workers
    makes them many times slower (the rule of ``README.md``'s "Tests on
    the CPU")."""
    with intra_op_threads(1):
        yield


ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "src"

#: Each DES module of the driver and the prefixes of the rows it prints.
DES_ROWS = {
    "fig01_fifo_luck": ("fig01.",),
    "fig03_staircase_trace": ("fig03.", "fig05."),
    "fig04_prediction_accuracy": ("fig04.",),
    "fig06_block_durations": ("fig06.",),
    "fig07_residency": ("fig07.", "fig08."),
    "fig09_corunner": ("fig09.", "fig10."),
    "fig11_ss_predictor": ("fig11.",),
    "table5_policies": ("table5.",),
    "fig14_15_16_per_workload": ("fig14.", "fig15.", "fig16."),
    "table6_arrival_offsets": ("table6.",),
    "scenarios_openloop": ("scenarios.",),
    "closedloop": ("closedloop.",),
}
PORTED = [f"benchmarks/{m}.py"
          for m in list(DES_ROWS) + ["common", "run", "perf"]] \
    + ["examples/cluster_sim.py"]

#: Lines of a ported module that differ from the reference's besides its
#: imports and the lines naming ``repro_torch``, in the order they appear:
#: the port's (``ADDED``) and the reference's they replace (``DROPPED``).
#: ``perf``'s: its output file, its baseline and history, the repo root of
#: ``_git_commit`` and where the table5 child runs.
ADDED = {
    "benchmarks/common.py": [
        "    ``machine=\"executor\"`` drives the cells through the lane "
        "executor",
        "    (``n_sm`` is then the lane count); see",
    ],
    "benchmarks/run.py": [
        "  the discrete-event simulator, ``executor`` for the lane executor "
        "on",
        "  the ``--device``; default both),",
        "  follow ``--jobs``),",
        "* ``--device D``    — torch device of the executor rows' blocks "
        "(default",
        "  ``cuda``, no fallback; the DES modules ignore it).",
        "        [--dispatch local|queue] [--workers 4] [--device cuda|cpu]",
        "    ap.add_argument(\"--device\", default=\"cuda\",",
        "                    help=\"torch device of the executor rows' "
        "blocks\")",
        "            # Executor rows: the run's device, jobs, cache and "
        "subset (on",
        "            # the local dispatcher, as common._dispatcher_for falls "
        "back).",
        "            rows = mod.run() if machine == \"des\" else mod.run(",
        "                args.device, common.JOBS, common.CACHE_DIR, "
        "common.SUBSET)",
    ],
    "benchmarks/perf.py": [
        'workloads, and writes ``BENCH_des_torch.json`` in the working '
        'directory',
        "(never the reference's ``BENCH_des.json``)::",
        '     "baseline": {...the port\'s own baseline measurements...},',
        "accumulates).  The ``baseline`` block pins the port's own "
        'measurements,',
        'taken with this same protocol on the host of an NVIDIA H100 machine '
        '— the',
        'reference every later run compares against; superseded baselines '
        'move',
        'under ``history`` (empty so far) so the whole trajectory stays '
        'readable',
        'from one file.',
        '        [--jobs 4] [--out BENCH_des_torch.json] [--repeat 2]',
        "#: The port's own measurements (tools/perf_baseline.py): this lane "
        'in full',
        '#: mode, ``--jobs 4 --repeat 3``, on the host of an NVIDIA H100 '
        'machine, at',
        "#: the last commit that changed the port's ``core`` — the floor the",
        "#: compiled engine is measured against (best-of-3; the host's CPUs "
        'are',
        '#: shared, so the best — least-contended — observation is the '
        'comparable',
        '#: one).',
        '    "commit": "f2ed5ff",',
        '    "protocol": ("best-of-3 measurements of `python -m "',
        '                 "(tools/perf_baseline.py; blocks/sec of the python '
        'engine, "',
        '                 "table5 walls under compiled-native) of "',
        '                 "model 207 stepping unknown (model name unknown), '
        '8 "',
        '                 "processors in /proc/cpuinfo, 8 usable, beside '
        'NVIDIA H100 "',
        '                 "80GB HBM3, 700.00 W; best = least-contended '
        'observation"),',
        '    "table5.cold.jobs4.wall_s.best": 2.88,',
        '    "table5.warm.jobs4.wall_s.best": 2.14,',
        '    "blocks_per_sec.table5_pair": 71_479.3,',
        '    "blocks_per_sec.mix4_10x": 179_938.5,',
        '    "blocks_per_sec.mgk_saturated": 14_088.5,',
        'HISTORY = []',
        '    root = Path(__file__).resolve().parents[3]',
        '    #: 10x-scaled four-program mix: the Section-6-scale shape that '
        'the',
        '    # The child runs from an empty temporary directory, where no '
        'package of',
        "    # the reference can be imported, with the port's ``src`` first "
        'on its',
        '    # path (a relative ``PYTHONPATH`` would not resolve from there).',
        '    src = str(Path(__file__).resolve().parents[2])',
        '    env = dict(os.environ, PYTHONPATH=os.pathsep.join(',
        '        p for p in (src, os.environ.get("PYTHONPATH")) if p))',
        '        with tempfile.TemporaryDirectory(prefix="bench_cwd_") as '
        'cwd:',
        '            t0 = time.perf_counter()',
        '            subprocess.run(argv, check=True, cwd=cwd, env=env,',
        '                           stdout=subprocess.DEVNULL)',
        '            return time.perf_counter() - t0',
        '        out: Path = Path("BENCH_des_torch.json"),',
        '        engine: str = "both") -> dict:',
        '    ap.add_argument("--out", default="BENCH_des_torch.json",',
        '                    help="output JSON, in the working directory '
        'unless a "',
        '                         "path is given (never the reference\'s "',
        '                         "BENCH_des.json)")',
    ],
    "examples/cluster_sim.py": [
        "def main(argv=None):",
        "    args = ap.parse_args(argv)",
    ],
}
DROPPED = {
    "benchmarks/common.py": [
        "    ``machine=\"executor\"`` drives the cells through the real-JAX "
        "lane",
        "    executor (``n_sm`` is then the lane count); see",
    ],
    "benchmarks/run.py": [
        "  the discrete-event simulator, ``executor`` for the real-JAX lane",
        "  executor; default both),",
        "  follow ``--jobs``).",
        "        [--dispatch local|queue] [--workers 4]",
        "            rows = mod.run()",
    ],
    "benchmarks/perf.py": [
        'workloads, and writes ``BENCH_des.json`` at the repo root::',
        '     "baseline": {...pre-PR reference measurements...},',
        'accumulates).  The ``baseline`` block pins the measurements taken '
        'at the',
        'PR-5 fast-path commit with this same protocol on this container — '
        'the',
        'reference every later ``make bench`` compares against; superseded',
        'baselines (the pre-fast-path interleaved measurements) are kept '
        'under',
        '``history`` so the whole trajectory stays readable from one file.',
        '        [--out BENCH_des.json] [--repeat 2]',
        '#: Reference measurements from the PR-5 fast-path commit (db3228f) '
        '— the',
        '#: floor the compiled engine is measured against.  Taken from the',
        '#: BENCH_des.json that commit wrote on this container (best-of-3 '
        'under',
        '#: the protocol below; the shared-CPU container fluctuates +/-30%, '
        'so the',
        '#: best — least-contended — observation is the comparable one).',
        '    "commit": "db3228f",',
        '    "protocol": ("best-of-3 measurements recorded by `make bench` '
        'at the "',
        '                 "PR-5 fast-path commit (python engine, this '
        'container); "',
        '                 "best = least-contended observation"),',
        '    "table5.cold.jobs4.wall_s.best": 17.87,',
        '    "table5.warm.jobs4.wall_s.best": 0.83,',
        '    "blocks_per_sec.table5_pair": 40_372.8,',
        '    "blocks_per_sec.mix4_10x": 101_710.1,',
        '    "blocks_per_sec.mgk_saturated": 8_887.5,',
        'HISTORY = [',
        '    {',
        '        "commit": "8244267",',
        '        "protocol": ("20 cold runs of the pre-fast-path commit '
        'interleaved "',
        '                     "with post-change runs; median and best "',
        '                     "(least-contended) observations recorded"),',
        '        "table5.cold.jobs4.wall_s.median": 56.2,',
        '        "table5.cold.jobs4.wall_s.best": 48.9,',
        '        "table5.warm.jobs4.wall_s.median": 1.49,',
        '        "table5.warm.jobs4.wall_s.best": 1.44,',
        '        "blocks_per_sec.table5_pair": 17_947.0,',
        '        "blocks_per_sec.mix4_10x": 31_304.0,',
        '        "blocks_per_sec.mgk_saturated": 4_267.0,',
        '    },',
        ']',
        '    root = Path(__file__).resolve().parent.parent',
        "    #: 10x-scaled four-program mix: the Section-6-scale shape the "
        "ISSUE's",
        '    env_root = Path(__file__).resolve().parent.parent',
        '        t0 = time.perf_counter()',
        '        subprocess.run(argv, check=True, cwd=env_root,',
        '                       stdout=subprocess.DEVNULL)',
        '        return time.perf_counter() - t0',
        '        out: Path = Path("BENCH_des.json"), engine: str = "both") '
        '-> dict:',
        '    ap.add_argument("--out", default="BENCH_des.json")',
    ],
    "examples/cluster_sim.py": [
        "def main():",
        "    args = ap.parse_args()",
    ],
}


def _code_lines(path: Path) -> list:
    """The file's lines without its import statements."""
    text = path.read_text()
    imports = [range(node.lineno, node.end_lineno + 1)
               for node in ast.walk(ast.parse(text))
               if isinstance(node, (ast.Import, ast.ImportFrom))]
    return [line for n, line in enumerate(text.splitlines(), 1)
            if not any(n in span for span in imports)]


@pytest.mark.parametrize("rel", PORTED)
def test_ported_module_is_the_references_text(rel):
    ref = _code_lines(ROOT / rel)
    port = _code_lines(SRC / "repro_torch" / rel)
    added, dropped = [], []
    for op, i1, i2, j1, j2 in difflib.SequenceMatcher(
            None, ref, port, autojunk=False).get_opcodes():
        if op == "equal":
            continue
        if op == "replace" and i2 - i1 == j2 - j1:
            # Line for line: a line renamed to the port's modules may
            # replace the reference's line in its place.
            pairs = [(r, p) for r, p in zip(ref[i1:i2], port[j1:j2])
                     if "repro_torch" not in p]
            dropped += [r for r, _ in pairs]
            added += [p for _, p in pairs]
        else:
            dropped += ref[i1:i2]
            added += [p for p in port[j1:j2] if "repro_torch" not in p]
    assert added == ADDED.get(rel, [])
    assert dropped == DROPPED.get(rel, [])


# ------------------------------------------------------------------ rows
class Run:
    """One driver run: its exit code, engine token and ``(name, derived)``
    rows."""

    def __init__(self, rc: int, stdout: str, stderr: str):
        self.rc, self.stderr = rc, stderr
        lines = stdout.splitlines()
        self.engine = next(line.split(" -> ")[1] for line in lines
                           if line.startswith("# engine="))
        body = lines[lines.index("name,us_per_call,derived") + 1:]
        self.rows = [(name, rest.split(",", 1)[1])
                     for name, rest in (line.split(",", 1) for line in body)]

    def of(self, module: str) -> list:
        return [row for row in self.rows
                if row[0].startswith(DES_ROWS[module])]


def _start(package: str, args, cwd: Path) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, "-m", f"{package}.run", *args], cwd=cwd,
        env=dict(os.environ, PYTHONPATH=str(SRC)), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def _finish(proc: subprocess.Popen) -> Run:
    out, err = proc.communicate(timeout=300)
    return Run(proc.returncode, out, err)


def port_run(args, cwd: Path) -> Run:
    return _finish(_start("repro_torch.benchmarks", args, cwd))


#: The two modes the rows are held in: full size under the compiled
#: engine, and the first two workloads of each scenario under the python
#: engine (the reference's event loop).
MODES = {
    "compiled": ["--machine", "des", "--no-cache", "--engine", "compiled"],
    "python-subset2": ["--machine", "des", "--no-cache", "--engine",
                       "python", "--subset", "2"],
}


@pytest.fixture(scope="module")
def des_runs(tmp_path_factory):
    """``{mode: (reference run, port run)}``, each pair run side by side
    once per mode."""
    cwd = tmp_path_factory.mktemp("port_cwd")
    procs = {mode: (_start("benchmarks", args, ROOT),
                    _start("repro_torch.benchmarks", args, cwd))
             for mode, args in MODES.items()}
    return {mode: (_finish(ref), _finish(port))
            for mode, (ref, port) in procs.items()}


@pytest.mark.parametrize("module", list(DES_ROWS))
@pytest.mark.parametrize("mode", list(MODES))
def test_des_rows_equal_the_references(mode, module, des_runs):
    ref, port = des_runs[mode]
    assert ref.rc == 0, ref.stderr
    assert port.rc == 0, port.stderr
    assert port.engine == ref.engine
    assert ref.of(module)
    assert port.of(module) == ref.of(module)
    # Every row belongs to a module: none failed (an ERROR row is named by
    # its module's path) and none slipped past the prefixes.
    names = [name for name, _ in port.rows]
    assert all(n.startswith(("roofline.",) + sum(DES_ROWS.values(), ()))
               for n in names), names


@pytest.fixture(scope="module")
def table5_local(tmp_path_factory):
    return port_run(["table5", "--subset", "2", "--no-cache"],
                    tmp_path_factory.mktemp("table5"))


@pytest.mark.parametrize("flags", [
    ["--jobs", "2"],
    ["--dispatch", "queue", "--workers", "2"],
], ids=["jobs2", "queue-workers2"])
def test_table5_rows_do_not_depend_on_the_dispatch(flags, table5_local,
                                                   tmp_path):
    run = port_run(["table5", "--subset", "2", "--no-cache"] + flags,
                   tmp_path)
    assert table5_local.rc == 0 and run.rc == 0, run.stderr
    assert table5_local.of("table5_policies")
    assert run.rows == table5_local.rows


def _executor_names(workloads) -> list:
    return ([f"executor.{wl}.{policy}" for wl in workloads
             for policy in executor_policies.POLICY_NAMES]
            + [f"executor.{wl}.srtf+ewma" for wl in workloads]
            + ["executor.note"])


def test_executor_rows_run_on_the_cpu_under_a_subset(tmp_path):
    run = port_run(["--machine", "executor", "--device", "cpu", "--subset",
                    "1", "--no-cache"], tmp_path)
    assert run.rc == 0, run.stderr
    assert [name for name, _ in run.rows] == _executor_names(["long+short"])
    assert all(derived.startswith('"stp=') for _, derived in run.rows[:-1])


def test_executor_rows_fail_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is valid")
    run = port_run(["--machine", "executor", "--no-cache"], tmp_path)
    assert run.rc == 1
    assert run.rows == [("repro_torch.benchmarks.executor_policies",
                         '"ERROR"')]
    assert "CUDA is not available" in run.stderr


@pytest.mark.parametrize("subset,workloads", [
    (1, ["long+short"]),
    (None, ["long+short", "medium+short"]),
], ids=["subset1", "all"])
def test_executor_policies_render_the_workloads_that_swept(subset,
                                                           workloads,
                                                           tmp_path):
    rows = executor_policies.run(device="cpu", cache_dir=tmp_path,
                                 subset=subset)
    assert [name for name, _ in rows] == _executor_names(workloads)


# ----------------------------------------------------------- cluster_sim
@pytest.mark.parametrize("argv", [[], ["--jobs", "40", "--seed", "3"]],
                         ids=["defaults", "jobs40-seed3"])
def test_cluster_sim_prints_the_references_lines(argv, capsys):
    ref = subprocess.run(
        [sys.executable, "examples/cluster_sim.py", *argv], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(SRC)), capture_output=True,
        text=True, timeout=300)
    assert ref.returncode == 0, ref.stderr
    cluster_sim.main(argv)
    out = capsys.readouterr().out
    assert out == ref.stdout
    assert len([line for line in out.splitlines()
                if "STP=" in line]) == 4


# ------------------------------------------------------------- perf lane
#: The lanes' flags in the rows test: the smoke workloads, once each.
PERF_FLAGS = ["--smoke", "--jobs", "2", "--repeat", "1"]
#: Row keys that do not depend on the clock.
PERF_KEYS = ("name", "blocks", "cells", "chunk", "exits", "segments",
             "engine", "best_of", "workers", "backend_detail")


class PerfRun:
    """One lane run: its exit code, output, working directory and the
    JSON it wrote."""

    def __init__(self, proc: subprocess.Popen, cwd: Path, out: Path):
        stdout, self.stderr = proc.communicate(timeout=300)
        self.rc, self.cwd = proc.returncode, cwd
        self.lines = stdout.splitlines()
        self.payload = json.loads(out.read_text()) if self.rc == 0 else None


def _start_perf(package: str, cwd: Path, *args) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, "-m", f"{package}.perf", *PERF_FLAGS, *args],
        cwd=cwd, env=dict(os.environ, PYTHONPATH=str(SRC)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def perf_runs(tmp_path_factory):
    """The reference's lane from the repo root and the port's from a
    temporary directory, each writing into another one, and the port's
    with its default ``--out`` from a third, side by side; with the bytes
    of the root's ``BENCH_des.json`` from before they ran."""
    out = tmp_path_factory.mktemp("perf_out")
    port_cwd = tmp_path_factory.mktemp("perf_cwd")
    default_cwd = tmp_path_factory.mktemp("perf_default")
    root_bytes = (ROOT / "BENCH_des.json").read_bytes()
    procs = {
        "ref": (_start_perf("benchmarks", ROOT, "--out",
                            str(out / "ref.json")), ROOT,
                out / "ref.json"),
        "port": (_start_perf("repro_torch.benchmarks", port_cwd, "--out",
                             str(out / "port.json")), port_cwd,
                 out / "port.json"),
        "default": (_start_perf("repro_torch.benchmarks", default_cwd),
                    default_cwd, default_cwd / "BENCH_des_torch.json"),
    }
    runs = {name: PerfRun(*args) for name, args in procs.items()}
    return runs, root_bytes


def _perf_view(payload: dict) -> tuple:
    """The parts of a lane's payload that do not depend on the clock."""
    return ([{key: row.get(key) for key in PERF_KEYS}
             for row in payload["rows"]],
            payload["smoke"], payload["compiled_backend"])


def test_perf_lane_rows_equal_the_references(perf_runs):
    runs, _ = perf_runs
    ref, port = runs["ref"], runs["port"]
    assert ref.rc == 0, ref.stderr
    assert port.rc == 0, port.stderr
    rows, smoke, _ = _perf_view(ref.payload)
    assert smoke is True and len(rows) == 11
    assert _perf_view(port.payload) == _perf_view(ref.payload)
    assert [json.loads(line) for line in port.lines[:-1]] \
        == port.payload["rows"]


def test_perf_lane_writes_its_own_file_in_the_working_directory(perf_runs):
    runs, root_bytes = perf_runs
    run = runs["default"]
    assert run.rc == 0, run.stderr
    assert inspect.signature(perf.run).parameters["out"].default \
        == Path("BENCH_des_torch.json")
    assert run.lines[-1].startswith("wrote BENCH_des_torch.json @ ")
    assert [p.name for p in run.cwd.iterdir()] == ["BENCH_des_torch.json"]
    assert _perf_view(run.payload) == _perf_view(runs["port"].payload)
    assert not (ROOT / "BENCH_des_torch.json").exists()
    assert (ROOT / "BENCH_des.json").read_bytes() == root_bytes


@pytest.mark.parametrize("commit,pinned", [
    ("abc1234", True), ("abc1234-dirty", False), ("unknown", False),
], ids=["clean", "dirty", "unknown"])
def test_perf_baseline_is_pinned_only_from_a_clean_commit(commit, pinned,
                                                          monkeypatch,
                                                          tmp_path):
    monkeypatch.setattr(perf, "_git_commit", lambda: commit)
    for rows_of in ("_throughput_rows", "_sweep_rows", "_dispatch_rows"):
        monkeypatch.setattr(perf, rows_of, lambda *args, **kwargs: [])
    payload = perf.run(out=tmp_path / "perf.json")
    assert json.loads((tmp_path / "perf.json").read_text()) == payload
    assert payload["commit"] == commit and payload["rows"] == []
    assert payload["history"] == perf.HISTORY == []
    if pinned:
        assert payload["baseline"] == perf.BASELINE
        assert "baseline_omitted" not in payload
    else:
        assert "baseline" not in payload
        assert "clean checkout" in payload["baseline_omitted"]


def test_perf_baseline_is_the_ports_own():
    """The reference's keys, the port's measurements: the commit of the
    port's core they were taken at, the host CPU and the card beside it
    named in the protocol."""
    tree = ast.parse((ROOT / "benchmarks" / "perf.py").read_text())
    ref = next(ast.literal_eval(node.value) for node in tree.body
               if isinstance(node, ast.Assign)
               and node.targets[0].id == "BASELINE")
    assert list(perf.BASELINE) == list(ref)
    assert perf.BASELINE["commit"] != ref["commit"]
    protocol = perf.BASELINE["protocol"]
    for part in (f"src/repro_torch/core at {perf.BASELINE['commit']}",
                 "/proc/cpuinfo", "NVIDIA H100", " W;"):
        assert part in protocol
    assert all(value > 0 for key, value in perf.BASELINE.items()
               if key not in ("commit", "protocol"))


@pytest.mark.parametrize("flags,message", [
    (["--repeat", "0"], "--repeat must be >= 1"),
    (["--jobs", "0"], "--jobs must be >= 1"),
    (["--engine", "jit"], "invalid choice"),
], ids=["repeat0", "jobs0", "engine"])
def test_perf_lane_refuses_bad_arguments(flags, message, monkeypatch,
                                         tmp_path, capsys):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "argv", ["perf", *flags])
    with pytest.raises(SystemExit) as exc:
        perf.main()
    assert exc.value.code == 2
    assert message in capsys.readouterr().err
    assert list(tmp_path.iterdir()) == []
