"""The port's static analyzer (``repro_torch.analysis``) against the
reference's (``repro.analysis``), on the CPU.

* Mirrors of ``tests/test_analysis.py``: each determinism lint on its
  known-bad snippet and the blessed idioms, the baseline logic, the clean
  tree, the fingerprint table against the import closure of the port's
  core, and the mutations of a scratch copy of ``src/repro_torch/core``
  that must turn the CLI red.
* Parity: on scratch copies of both packages' cores, and on every mutated
  copy, the port's ``run_passes`` returns the reference's findings, tuple
  for tuple, with the same messages once ``repro_torch`` reads ``repro``.
* Copy identity: each module is the reference's text save its imports,
  the lines naming ``repro_torch`` and the lines in ``ADDED`` /
  ``DROPPED``.
* The root rule: on the canonical tree the determinism pass also lints
  ``src/repro_torch/benchmarks/*.py`` and ``tests/test_torch_*.py``, as
  the reference's lints its ``benchmarks/*.py`` and ``tests/*.py``.

Both packages' repo-level scans lint this file, so every bad snippet lives
in a string.
"""

import ast
import difflib
import json
import shutil
from pathlib import Path

import pytest

import repro.analysis as ref
from repro_torch import intra_op_threads
from repro_torch.analysis import (
    Baseline,
    Finding,
    apply_baseline,
    check_fingerprint_coverage,
    check_machine_signatures,
    check_policy_hints,
    check_protocols,
    expected_fingerprint_sources,
    load_fingerprint_table,
    main,
    run_passes,
    scan_determinism,
    scan_source,
)
from repro_torch.analysis import importgraph, report
from repro_torch.analysis.determinism import repo_scan_files
from repro_torch.core.sweep import fingerprint_sources


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The module's CPU work on one intra-op thread: its small products
    would wake every thread, which under the suite's parallel workers
    makes them many times slower (the rule of ``README.md``'s "Tests on
    the CPU")."""
    with intra_op_threads(1):
        yield


ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
CORE_DIR = PORT / "core"
REF_CORE_DIR = ROOT / "src" / "repro" / "core"
BASELINE = PORT / "analysis" / "baseline.json"


def _copy_core(src: Path, dst: Path) -> Path:
    dst.mkdir(parents=True)
    for path in sorted(src.glob("*.py")):
        shutil.copy(path, dst / path.name)
    return dst


def _tuples(findings) -> list:
    return [(f.pass_name, f.rule, f.module, f.context, f.line)
            for f in findings]


def _assert_parity(got, want) -> None:
    """The port's findings are the reference's, messages included once the
    port's package name reads as the reference's."""
    assert _tuples(got) == _tuples(want)
    assert [f.message.replace("repro_torch", "repro") for f in got] == \
        [f.message for f in want]


# ------------------------------------------------------- per-rule fixtures
BAD_SNIPPETS = {
    "unseeded-random": "import random\n\ndef f():\n    return random.random()\n",
    "unseeded-random-numpy": (
        "import numpy as np\n\ndef f():\n    return np.random.rand()\n"),
    "set-iteration": (
        "def f():\n    out = []\n    for x in {1, 2, 3}:\n"
        "        out.append(x)\n    return out\n"),
    "set-iteration-keyed-sort": (
        "def f(xs):\n    return sorted(set(xs), key=lambda v: v % 3)\n"),
    "dict-popitem": "def f(d):\n    return d.popitem()\n",
    "id-in-key": "def f(xs):\n    return sorted(xs, key=lambda v: id(v))\n",
    "wallclock": "import time\n\ndef f():\n    return time.time()\n",
    "wallclock-datetime": (
        "import datetime\n\ndef f():\n    return datetime.datetime.now()\n"),
    "uuid": "import uuid\n\ndef f():\n    return str(uuid.uuid4())\n",
    "nan-json": "import json\n\ndef f(x):\n    return json.dumps(x)\n",
}
EXPECTED_RULE = {
    "unseeded-random-numpy": "unseeded-random",
    "set-iteration-keyed-sort": "set-iteration",
    "wallclock-datetime": "wallclock",
}


@pytest.mark.parametrize("name", sorted(BAD_SNIPPETS))
def test_each_determinism_lint_fires_exactly_once(name):
    findings = scan_source(BAD_SNIPPETS[name], module=name)
    rule = EXPECTED_RULE.get(name, name)
    assert [f.rule for f in findings] == [rule], (
        f"{name}: expected exactly one {rule!r} finding, got "
        f"{[f.format() for f in findings]}")
    (finding,) = findings
    assert finding.context == "f"
    assert finding.module == name
    _assert_parity(findings, ref.scan_source(BAD_SNIPPETS[name], module=name))


GOOD_SNIPPETS = {
    # Key-less sorted() over a set is a total order on distinct elements:
    # ties cannot fall back to the salted-hash iteration order.
    "total-sort": "def f(xs):\n    return sorted(set(xs))\n",
    # Seeded generators are the blessed randomness source.
    "seeded-rng": (
        "import random\n\ndef f(seed):\n"
        "    return random.Random(seed).random()\n"),
    "numpy-generator": (
        "import numpy as np\n\ndef f(seed):\n"
        "    return np.random.default_rng(seed).random()\n"),
    # Explicit allow_nan decision (either way) satisfies the JSON rule.
    "json-allow-nan": (
        "import json\n\ndef f(x):\n"
        "    return json.dumps(x, allow_nan=False)\n"),
    # Membership tests over sets are order-insensitive.
    "set-membership": "def f(x, xs):\n    return x in set(xs)\n",
}


@pytest.mark.parametrize("name", sorted(GOOD_SNIPPETS))
def test_blessed_idioms_stay_clean(name):
    assert scan_source(GOOD_SNIPPETS[name], module=name) == []
    assert ref.scan_source(GOOD_SNIPPETS[name], module=name) == []


# --------------------------------------------------------- baseline logic
def _finding(rule="wallclock", module="m", context="c", line=1):
    return Finding("determinism", rule, module, context, line, "msg")


def test_baseline_suppresses_up_to_count_and_blocks_excess():
    base = Baseline(entries={"wallclock::m::c": (1, "justified")})
    report = apply_baseline([_finding(line=3), _finding(line=9)], base)
    assert len(report.suppressed) == 1
    assert len(report.blocking) == 1
    assert not report.ok


def test_baseline_with_empty_reason_blocks():
    base = Baseline(entries={"wallclock::m::c": (1, "  ")})
    report = apply_baseline([_finding()], base)
    assert report.empty_reasons and not report.ok


def test_stale_baseline_entry_is_reported_not_fatal():
    base = Baseline(entries={"wallclock::gone::x": (1, "was fixed")})
    report = apply_baseline([], base)
    assert report.stale_keys == ["wallclock::gone::x"]
    assert report.ok


def test_non_baselinable_pass_cannot_be_suppressed():
    fp = Finding("fingerprint", "under-coverage", "sweep", "des", 1, "msg")
    base = Baseline(entries={fp.key: (1, "nice try")})
    report = apply_baseline([fp], base)
    assert report.blocking == [fp]


# ------------------------------------------------------------ clean tree
def test_clean_tree_cli_exits_zero(capsys):
    assert main([]) == 0
    out = capsys.readouterr().out
    assert out.splitlines()[-1] == (
        "0 blocking finding(s), 26 baselined, 0 stale baseline entr(y/ies)")


def test_clean_tree_json_is_ok_and_stable_sorted(capsys):
    assert main(["--json"]) == 0
    payload = json.loads(capsys.readouterr().out)
    assert payload["ok"] is True
    records = payload["findings"]
    assert len(records) == 26
    assert all(r["suppressed"] and r["pass"] == "determinism"
               for r in records)
    keys = [(r["file"], r["line"], r["pass"], r["rule"], r["context"],
             r["message"]) for r in records]
    assert keys == sorted(keys)
    assert [r["location"] for r in records
            if r["file"].startswith("benchmarks/")] == [
        "benchmarks/perf.py:162", "benchmarks/perf.py:164",
        "benchmarks/perf.py:289", "benchmarks/perf.py:293",
        "benchmarks/perf.py:343", "benchmarks/perf.py:346",
        "benchmarks/perf.py:417", "benchmarks/perf.py:444",
        "benchmarks/run.py:130", "benchmarks/run.py:135"]


def test_every_baseline_entry_has_a_reason_and_matches():
    payload = json.loads(BASELINE.read_text())
    entries = payload["entries"]
    assert payload["version"] == 1
    assert [e["key"] for e in entries] == sorted(e["key"] for e in entries)
    assert all(e["reason"].strip() for e in entries)
    report = apply_baseline(scan_determinism(CORE_DIR),
                            Baseline.load(BASELINE))
    assert report.ok and not report.blocking
    assert report.stale_keys == [] and report.empty_reasons == []
    assert sum(e["count"] for e in entries) == len(report.suppressed) == 26


def test_clean_tree_has_no_protocol_findings():
    assert check_protocols(CORE_DIR) == []


def test_clean_tree_has_no_fingerprint_findings():
    assert check_fingerprint_coverage(CORE_DIR) == []


# ------------------------------------------------------- bridge assertions
def test_fingerprint_table_equals_import_closure():
    """``_FINGERPRINT_SOURCES`` of the port's ``sweep.py`` equals the
    closure the analyzer computes over the port's core, machine for
    machine."""
    runtime = fingerprint_sources()
    expected = expected_fingerprint_sources(CORE_DIR)
    assert set(runtime) == set(expected) == {"des", "des-closed", "executor"}
    for machine in sorted(expected):
        assert set(runtime[machine]) == expected[machine], (
            f"{machine}: _FINGERPRINT_SOURCES drifted from the import "
            f"closure")


def test_static_table_parse_matches_runtime_table():
    static = load_fingerprint_table(CORE_DIR)
    assert static == fingerprint_sources()


def test_fingerprint_tuples_are_sorted_and_unique():
    for machine, mods in fingerprint_sources().items():
        assert sorted(set(mods)) == sorted(mods), machine


def test_distrib_joins_every_fingerprint_closure():
    """The cell runner and record store (``distrib.py``) are in every
    machine's fingerprint, so an edit there re-keys cached records on
    dispatcher and workers alike."""
    for machine, mods in fingerprint_sources().items():
        assert "distrib" in mods, machine


# --------------------------------------------------------- mutation tests
#: Each mutation of a scratch copy of the port's core, as ``(file, anchor,
#: replacement)`` edits (anchor ``None``: append to the file, or create
#: it), with the pass that must see it, the rules it may report and the
#: module it must name (``None``: any).
MUTATIONS = {
    "dropped-fingerprint-module": (
        [("sweep.py", '"metrics"', '"metrics_gone"')],
        check_fingerprint_coverage, ("under-coverage", "stale-entry"), None),
    "dropped-engine-module": (
        [("sweep.py", '"fastsim_c"', '"fastsim_c_gone"')],
        check_fingerprint_coverage, ("under-coverage",), "fastsim_c"),
    "dropped-distrib": (
        [("sweep.py", '"des": ("distrib"', '"des": ("distrib_gone"')],
        check_fingerprint_coverage, ("under-coverage",), "distrib"),
    "shadow-module": (
        [("shadow_helper.py", None,
          "from . import workload\n\n"
          "def tweak(spec):\n    return workload.scaled_spec(spec, 2.0)\n")],
        check_fingerprint_coverage, ("unclassified-module",), None),
    "undeclared-predictor-use": (
        [("policies.py", "class SRTF(Policy):\n",
          "class SRTF(Policy):\n    uses_predictor = False\n")],
        check_policy_hints, ("undeclared-predictor-use",), None),
    "unseeded-rng": (
        [("simulator.py", None,
          "\n\ndef _jitter():\n    import random\n"
          "    return random.random()\n")],
        scan_determinism, ("unseeded-random",), "simulator"),
    "protocol-signature-drift": (
        [("executor.py", "def residency(self, key: str, sm: int)",
          "def residency(self, key: str, lane: int)")],
        check_machine_signatures, ("signature-drift",), None),
}


@pytest.fixture()
def scratch_core(tmp_path):
    return _copy_core(CORE_DIR, tmp_path / "core")


def _mutate(core: Path, edits) -> None:
    for filename, old, new in edits:
        path = core / filename
        text = path.read_text() if path.exists() else ""
        if old is None:
            path.write_text(text + new)
            continue
        assert old in text, f"mutation anchor missing in {filename}: {old!r}"
        path.write_text(text.replace(old, new, 1))


@pytest.mark.parametrize("name", sorted(MUTATIONS))
def test_mutation_turns_the_cli_red(name, scratch_core):
    edits, check, rules, module = MUTATIONS[name]
    _mutate(scratch_core, edits)
    findings = check(scratch_core)
    assert any(f.rule in rules and module in (None, f.module)
               for f in findings), [f.format() for f in findings]
    assert main(["--core-dir", str(scratch_core)]) == 1


def test_clean_scratch_copy_passes(scratch_core):
    """The scratch copy itself is clean — mutations, not copying, fail."""
    assert main(["--core-dir", str(scratch_core)]) == 0


# ----------------------------------------------------------------- parity
@pytest.mark.parametrize("case", ["repro-core", "repro_torch-core"]
                         + sorted(MUTATIONS))
def test_findings_equal_the_references(case, tmp_path):
    """Both analyzers over one scratch core: a copy of either package's,
    or the port's with one mutation applied."""
    src = REF_CORE_DIR if case == "repro-core" else CORE_DIR
    core = _copy_core(src, tmp_path / "core")
    if case in MUTATIONS:
        _mutate(core, MUTATIONS[case][0])
    got = run_passes(core)
    _assert_parity(got, ref.run_passes(core))
    if case not in MUTATIONS:
        assert len(got) == 16
        assert {f.pass_name for f in got} == {"determinism"}


# ---------------------------------------------------------- copy identity
#: Lines of a ported module that differ from the reference's besides its
#: imports and the lines naming ``repro_torch``, in the order they appear:
#: the port's (``ADDED``) and the reference's they replace (``DROPPED``).
ADDED = {
    "cli.py": [
        "itself crashed or was misused.  ``chip_smoke.py`` runs this as its "
        "last",
        "phase, with ``--json``, which emits stable-sorted machine-readable",
    ],
    "conformance.py": ["carry a reason a maintainer can audit."],
    "determinism.py": [
        "recognized locally is a hazard a reader cannot recognize either, "
        "and a",
        "#: Repo-level files the pass also lints, as ``(label, directory "
        "under the",
        "#: repo root, pattern)``: the port's benchmark modules (they drive "
        "cached",
        "#: sweeps) and the port's tests (they pin the reference's bytes) —",
        "#: nondeterminism there corrupts both.  The labels are the "
        "reference's, so",
        "#: a finding keys as ``benchmarks/<stem>`` or ``tests/<stem>``.",
        '                  ("tests", "tests", "test_torch_*.py"))',
        "    for label, dirname, pattern in REPO_SCAN_DIRS:",
        "        for path in sorted(d.glob(pattern)):",
        '            out.append((f"{label}/{path.stem}", path))',
    ],
    "importgraph.py": [
        "",
        "``scenarios.executor_job`` imports the device resolver from the "
        "package",
        "root (``from .. import resolve_device``): that import leaves",
        "does not follow it; the device it resolves is folded into the "
        "executor",
        "cache keys (``sweep._device_name``).",
        "#: cells — the arrival-process code.  distrib.py — the cell",
    ],
    "protocol.py": [
        "   dispatch of the corresponding typed branches of ``post()`` "
        "(their",
    ],
    "report.py": [
        'Baseline workflow (DESIGN.md Section 9; README.md, "Static '
        'analysis"): fix',
        "the finding, or add an inline justification comment at the site "
        "*and* an",
        "entry to this package's own ``baseline.json`` (not the reference's) "
        "via",
    ],
}
DROPPED = {
    "cli.py": [
        "itself crashed or was misused.  CI runs this (via ``make analyze``)",
        "before the test tiers; ``--json`` emits stable-sorted "
        "machine-readable",
    ],
    "conformance.py": ["carry a reason the reviewer can audit."],
    "determinism.py": [
        "recognized locally is a hazard a reviewer cannot recognize either, "
        "and a",
        "#: Repo-level directories the pass also lints (benchmarks drive "
        "cached",
        "#: sweeps; tests pin golden bytes — nondeterminism there corrupts "
        "both).",
        'REPO_SCAN_DIRS = ("benchmarks", "tests")',
        "    for dirname in REPO_SCAN_DIRS:",
        '        for path in sorted(d.glob("*.py")):',
        '            out.append((f"{dirname}/{path.stem}", path))',
    ],
    "importgraph.py": [
        "#: cells — the arrival-process code.  Since PR 9, distrib.py — the "
        "cell",
    ],
    "protocol.py": [
        "   dispatch of the corresponding typed branches of ``post()`` "
        "(PR 5's",
    ],
    "report.py": [
        "Baseline workflow (DESIGN.md Section 9): fix the finding, or add "
        "an inline",
        "justification comment at the site *and* an entry here via",
        "``python -m repro.analysis --write-baseline`` (then fill in the",
    ],
}
MODULES = sorted(p.name for p in (ROOT / "src" / "repro" / "analysis")
                 .glob("*.py"))


def _code_lines(path: Path) -> list:
    """The file's lines without its import statements."""
    text = path.read_text()
    imports = [range(node.lineno, node.end_lineno + 1)
               for node in ast.walk(ast.parse(text))
               if isinstance(node, (ast.Import, ast.ImportFrom))]
    return [line for n, line in enumerate(text.splitlines(), 1)
            if not any(n in span for span in imports)]


def test_every_module_of_the_reference_is_ported():
    assert MODULES == sorted(p.name for p in (PORT / "analysis")
                             .glob("*.py"))
    assert len(MODULES) == 12


@pytest.mark.parametrize("name", MODULES)
def test_ported_module_is_the_references_text(name):
    ref_lines = _code_lines(ROOT / "src" / "repro" / "analysis" / name)
    port = _code_lines(PORT / "analysis" / name)
    added, dropped = [], []
    for op, i1, i2, j1, j2 in difflib.SequenceMatcher(
            None, ref_lines, port, autojunk=False).get_opcodes():
        if op == "equal":
            continue
        if op == "replace" and i2 - i1 == j2 - j1:
            # Line for line: a line renamed to the port's package may
            # replace the reference's line in its place.
            pairs = [(r, p) for r, p in zip(ref_lines[i1:i2], port[j1:j2])
                     if "repro_torch" not in p]
            dropped += [r for r, _ in pairs]
            added += [p for _, p in pairs]
        else:
            dropped += ref_lines[i1:i2]
            added += [p for p in port[j1:j2] if "repro_torch" not in p]
    assert added == ADDED.get(name, [])
    assert dropped == DROPPED.get(name, [])


def test_port_keys_its_own_package():
    assert importgraph.CORE_PACKAGE == "repro_torch.core"
    assert importgraph.CORE_DIR == CORE_DIR
    assert report.DEFAULT_BASELINE_PATH == BASELINE


# -------------------------------------------------------------- root rule
def _port_repo_files() -> list:
    return ([(f"benchmarks/{p.stem}", p)
             for p in sorted((PORT / "benchmarks").glob("*.py"))]
            + [(f"tests/{p.stem}", p)
               for p in sorted((ROOT / "tests").glob("test_torch_*.py"))])


def test_root_rule_lists_the_ports_benchmarks_and_tests():
    files = repo_scan_files(CORE_DIR)
    assert files == _port_repo_files()
    labels = [label for label, _ in files]
    assert "benchmarks/run" in labels and "tests/test_torch_analysis" in labels
    assert not any(label.startswith("tests/test_analysis") for label in labels)
    assert repo_scan_files(REF_CORE_DIR) == []


def test_root_rule_finds_what_the_references_scanner_finds():
    """The port's determinism pass over its tree is the reference's scanner
    over the port's core (core-only: it is not ``src/repro/core``) plus
    each repo-level file under the same label."""
    want = list(ref.scan_determinism(CORE_DIR))
    for label, path in _port_repo_files():
        want.extend(ref.scan_source(path.read_text(), module=label))
    want.sort(key=lambda f: (f.module, f.line, f.rule))
    _assert_parity(scan_determinism(CORE_DIR), want)


#: A wall-clock read appended to a file of the scratch tree.
STAMP = "\n\ndef _stamp():\n    import time\n    return time.time()\n"


@pytest.fixture()
def scratch_repo(tmp_path):
    """``<tmp>/src/repro_torch/{core,benchmarks,examples}`` and
    ``<tmp>/tests`` holding copies of the port's files."""
    port = tmp_path / "src" / "repro_torch"
    _copy_core(CORE_DIR, port / "core")
    _copy_core(PORT / "benchmarks", port / "benchmarks")
    _copy_core(PORT / "examples", port / "examples")
    (tmp_path / "tests").mkdir()
    for path in sorted((ROOT / "tests").glob("test_torch_*.py")):
        shutil.copy(path, tmp_path / "tests" / path.name)
    return tmp_path


@pytest.mark.parametrize("rel,label", [
    ("src/repro_torch/benchmarks/fig01_fifo_luck.py",
     "benchmarks/fig01_fifo_luck"),
    ("src/repro_torch/benchmarks/run.py", "benchmarks/run"),
    ("tests/test_torch_serve.py", "tests/test_torch_serve"),
    ("tests/test_torch_wallclock.py", "tests/test_torch_wallclock"),
    ("tests/test_wallclock.py", None),
    ("tests/test_analysis.py", None),
    ("src/repro_torch/examples/cluster_sim.py", None),
], ids=lambda v: v if isinstance(v, str) else "unscanned")
def test_root_rule_lints_the_ports_repo_files(rel, label, scratch_repo,
                                              capsys):
    core = scratch_repo / "src" / "repro_torch" / "core"
    assert main(["--core-dir", str(core)]) == 0
    capsys.readouterr()
    _mutate(scratch_repo, [(rel, None, STAMP)])
    assert main(["--core-dir", str(core), "--json"]) == (1 if label else 0)
    payload = json.loads(capsys.readouterr().out)
    blocking = [(r["rule"], r["file"], r["context"])
                for r in payload["findings"] if not r["suppressed"]]
    assert blocking == ([("wallclock", f"{label}.py", "_stamp")]
                        if label else [])
    assert payload["ok"] is (label is None)


def test_core_dir_elsewhere_is_scanned_core_only(scratch_repo, tmp_path):
    """A ``--core-dir`` tree that is not ``<root>/src/repro_torch/core``
    lints its core alone, as the reference's does."""
    moved = tmp_path / "elsewhere" / "core"
    shutil.copytree(scratch_repo / "src" / "repro_torch" / "core", moved)
    assert repo_scan_files(moved) == []
    _assert_parity(scan_determinism(moved), ref.scan_determinism(moved))
    assert len(scan_determinism(moved)) == 16
