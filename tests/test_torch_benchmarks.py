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

Each driver runs in a subprocess of its own (``common`` keeps module-level
configuration and memoises Table 5): the reference's from the repo root,
which puts its ``benchmarks`` package on the path, the port's from a
temporary directory, where no package of the reference can be imported.
"""

import ast
import difflib
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import intra_op_threads
from repro_torch.benchmarks import executor_policies
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
PORTED = [f"benchmarks/{m}.py" for m in list(DES_ROWS) + ["common", "run"]] \
    + ["examples/cluster_sim.py"]

#: Lines of a ported module that differ from the reference's besides its
#: imports and the lines naming ``repro_torch``, in the order they appear:
#: the port's (``ADDED``) and the reference's they replace (``DROPPED``).
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
