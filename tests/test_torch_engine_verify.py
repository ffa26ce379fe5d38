"""The port's engine-verification passes against the reference's, on the
CPU.

Mirrors of ``tests/test_engine_verify.py`` over a scratch copy of
``src/repro_torch/core``: each unmirrored edit of the kind the passes exist
to catch turns the port's CLI red (exit 1) with the expected rule, the
clean copy stays green, ``--json`` keeps its contract and a crash exits 2.
On the clean copy and on every mutated one, the port's ``run_passes``
returns the reference's findings, tuple for tuple, with the same messages
once ``repro_torch`` reads ``repro`` (a crash raises the same error in
both).
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

import repro.analysis as ref
from repro_torch import intra_op_threads
from repro_torch.analysis import (
    main,
    run_passes,
    scan_conformance,
    scan_layout,
    scan_translation,
)
from repro_torch.analysis.importgraph import CORE_DIR


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The module's CPU work on one intra-op thread: its small products
    would wake every thread, which under the suite's parallel workers
    makes them many times slower (the rule of ``README.md``'s "Tests on
    the CPU")."""
    with intra_op_threads(1):
        yield


BASELINE = Path(__file__).resolve().parent.parent / "src" / "repro_torch" / \
    "analysis" / "baseline.json"

ENGINE_PASSES = "conformance,translate,layout"


@pytest.fixture()
def scratch_core(tmp_path):
    dst = tmp_path / "core"
    dst.mkdir()
    for path in sorted(CORE_DIR.glob("*.py")):
        shutil.copy(path, dst / path.name)
    return dst


def _mutate(core: Path, edits) -> None:
    for filename, old, new in edits:
        path = core / filename
        text = path.read_text()
        assert old in text, f"mutation anchor not found in {filename}: {old!r}"
        path.write_text(text.replace(old, new, 1))


def _cli(core: Path, *extra: str) -> int:
    return main(["--core-dir", str(core), "--baseline", str(BASELINE),
                 "--passes", ENGINE_PASSES, *extra])


def _rules(findings):
    return {f.rule for f in findings}


# ------------------------------------------------------------ green path
def test_clean_scratch_copy_is_green(scratch_core, capsys):
    assert _cli(scratch_core) == 0
    assert "0 blocking finding(s)" in capsys.readouterr().out


def test_clean_tree_engine_passes_have_no_findings(scratch_core):
    assert scan_conformance(scratch_core) == []
    assert scan_translation(scratch_core) == []
    assert scan_layout(scratch_core) == []


# -------------------------------------------------------------- mutations
#: Each mutation of a scratch copy of the port's core as ``(file, anchor,
#: replacement)`` edits, with the pass that must see it, the rules it must
#: report and a text one of its findings' context or message must hold
#: (``None``: no such check).
MUTATIONS = {
    # translate: pair diffs.  The twin-side mutation relaxes one
    # comparison in _pred_remaining without touching the C mirror.
    "unmirrored-twin-edit": (
        [("fastsim_twin.py", "if rb < 0:", "if rb <= 0:")],
        scan_translation, ("pair-mismatch",), "_pred_remaining"),
    "swapped-comparison-in-c": (
        [("fastsim_c.py", "if (ki != kj) return ki < kj;",
          "if (ki != kj) return ki <= kj;")],
        scan_translation, ("pair-mismatch",), None),
    "missing-c-function": (
        [("fastsim_c.py", "static void broadcast_t(",
          "static void broadcast_t_x(")],
        scan_translation, ("missing-function", "extra-function"), None),
    # Deleting a mirrored write shows up as a bag mismatch even though
    # control flow is unchanged.
    "dropped-twin-statement": (
        [("fastsim_twin.py",
          "    sd[SD_BUSY] = sd[SD_BUSY] + (now - start) * frac\n",
          "    pass\n")],
        scan_translation, ("pair-mismatch",), None),
    # translate: numeric C lints.  A hand-written #define shadowing the
    # generated block with a different value.
    "c-constant-drift": (
        [("fastsim_c.py", "typedef struct {",
          "#define SMI_LEN 9\ntypedef struct {")],
        scan_translation, ("constant-drift",), "SMI_LEN"),
    "missing-fp-contract-flag": (
        [("fastsim_c.py", '"-ffp-contract=off",', "")],
        scan_translation, ("fma-contract",), None),
    "narrowed-dtype": (
        [("fastsim_c.py", "int64_t rb, res;", "int rb, res;")],
        scan_translation, ("narrowed-dtype",), None),
    "int-division": (
        [("fastsim_c.py", "return ((double)rb / (double)res) * t;",
          "return ((double)(rb / res)) * t;")],
        scan_translation, ("int-division",), None),
    # layout: shapes.
    "stride-off-by-one": (
        [("fastsim_c.py", "S->tri[(i) * 3 + (c)]", "S->tri[(i) * 4 + (c)]")],
        scan_layout, ("stride-mismatch",), None),
    "dropped-buffer-growth-exit": (
        [("fastsim_twin.py",
          "        if ci[CI_REC_PRED] != 0 and si[SI_PRED_N] + 4 "
          "> ci[CI_PRED_CAP]:\n            return 6\n", "")],
        scan_layout, ("missing-growth-exit",), "CI_PRED_CAP"),
    "field-table-renumber": (
        [("fastsim_twin.py", "RF_EXCL = 11", "RF_EXCL = 13")],
        scan_layout, ("family-gap", "col-bounds"), None),
    "wrong-family-column": (
        [("fastsim_twin.py", "ri[r, RI_DONE]", "ri[r, RF_MEANT]")],
        scan_layout, ("wrong-family",), None),
    "unassigned-capacity": (
        [("fastsim.py", "ci[tw.CI_PRED_CAP] = pred_cap", "pass")],
        scan_layout, ("cap-unassigned",), None),
    "state-tuple-swap": (
        [("fastsim.py", "act, queue, rwi, rwf, newc, cand, crem,",
          "act, queue, rwf, rwi, newc, cand, crem,")],
        scan_layout, ("alloc-width",), None),
    # conformance: the nopython subset.
    "subset-violation": (
        [("fastsim_twin.py", "    if rb < 0:",
          "    order = sorted([rb])\n    if rb < 0:")],
        scan_conformance, ("subset-call",), None),
    "narrow-numpy-dtype": (
        [("fastsim_twin.py",
          "batch = np.empty((MAX_BLOCK_SLOTS, 4), np.int64)",
          "batch = np.empty((MAX_BLOCK_SLOTS, 4), np.int32)")],
        scan_conformance, ("subset-dtype",), None),
    # Both mutations of the --json contract test below.
    "json-contract": (
        [("fastsim_twin.py", "if rb < 0:", "if rb <= 0:"),
         ("fastsim_c.py", "S->tri[(i) * 3 + (c)]", "S->tri[(i) * 4 + (c)]")],
        scan_translation, ("pair-mismatch",), None),
}


@pytest.mark.parametrize("name", sorted(MUTATIONS))
def test_mutation_turns_red(name, scratch_core):
    edits, scan, rules, text = MUTATIONS[name]
    _mutate(scratch_core, edits)
    findings = scan(scratch_core)
    assert set(rules) <= _rules(findings), [f.format() for f in findings]
    if text is not None:
        assert any(text in f.context or text in f.message
                   for f in findings)
    assert _cli(scratch_core) == 1


@pytest.mark.parametrize("name", ["clean"] + sorted(MUTATIONS))
def test_findings_equal_the_references(name, scratch_core):
    if name != "clean":
        _mutate(scratch_core, MUTATIONS[name][0])
    got = run_passes(scratch_core)
    want = ref.run_passes(scratch_core)
    assert [(f.pass_name, f.rule, f.module, f.context, f.line)
            for f in got] == \
        [(f.pass_name, f.rule, f.module, f.context, f.line) for f in want]
    assert [f.message.replace("repro_torch", "repro") for f in got] == \
        [f.message for f in want]
    engine = [f for f in got if f.pass_name != "determinism"]
    assert bool(engine) == (name != "clean")


# --------------------------------------------------------- CLI contract
def test_cli_exit_2_on_analyzer_crash(scratch_core, capsys):
    (scratch_core / "fastsim_twin.py").write_text("def (broken\n")
    assert _cli(scratch_core) == 2
    assert "analyzer crashed" in capsys.readouterr().err
    with pytest.raises(SyntaxError):
        run_passes(scratch_core)
    with pytest.raises(SyntaxError):
        ref.run_passes(scratch_core)


def test_json_output_clean(scratch_core, capsys):
    assert _cli(scratch_core, "--json") == 0
    payload = json.loads(capsys.readouterr().out)
    assert payload["ok"] is True
    assert payload["findings"] == []


def test_json_output_records_are_stable_sorted(scratch_core, capsys):
    _mutate(scratch_core, MUTATIONS["json-contract"][0])
    assert _cli(scratch_core, "--json") == 1
    payload = json.loads(capsys.readouterr().out)
    assert payload["ok"] is False
    records = payload["findings"]
    assert records, "expected findings in JSON output"
    for record in records:
        assert set(record) == {"pass", "rule", "file", "line", "location",
                               "context", "message", "suppressed"}
        assert record["location"] == f"{record['file']}:{record['line']}"
    keys = [(r["file"], r["line"], r["pass"], r["rule"], r["context"],
             r["message"]) for r in records]
    assert keys == sorted(keys)
    assert {r["pass"] for r in records} == {"translate", "layout"}
