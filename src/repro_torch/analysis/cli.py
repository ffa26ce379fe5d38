"""``python -m repro_torch.analysis`` — run the determinism & cache-integrity
analyzer and the engine-verification passes.

Exit status: 0 when every pass is clean (modulo the checked-in
baseline), 1 when any non-baselined finding blocks, 2 when the analyzer
itself crashed or was misused.  ``chip_smoke.py`` runs this as its last
phase, with ``--json``, which emits stable-sorted machine-readable
records for tooling.
"""

from __future__ import annotations

import argparse
import json
import sys
import traceback
from pathlib import Path
from typing import List, Optional, Sequence

from .conformance import scan_conformance
from .determinism import scan_determinism
from .importgraph import CORE_DIR, check_fingerprint_coverage
from .layout import scan_layout
from .protocol import check_protocols
from .report import (
    BASELINABLE_PASSES,
    Baseline,
    Finding,
    apply_baseline,
    format_report,
)
from .translate import scan_translation

PASSES = ("fingerprint", "determinism", "protocol", "conformance",
          "translate", "layout")


def run_passes(core_dir: Optional[Path] = None,
               passes: Sequence[str] = PASSES) -> List[Finding]:
    findings: List[Finding] = []
    if "fingerprint" in passes:
        findings.extend(check_fingerprint_coverage(core_dir))
    if "determinism" in passes:
        findings.extend(scan_determinism(core_dir))
    if "protocol" in passes:
        findings.extend(check_protocols(core_dir))
    resolved = Path(core_dir) if core_dir is not None else CORE_DIR
    if "conformance" in passes:
        findings.extend(scan_conformance(resolved))
    if "translate" in passes:
        findings.extend(scan_translation(resolved))
    if "layout" in passes:
        findings.extend(scan_layout(resolved))
    return findings


def _json_records(report) -> str:
    """Stable-sorted machine-readable findings (blocking + suppressed)."""
    records = []
    for f, suppressed in ([(f, False) for f in report.blocking]
                          + [(f, True) for f in report.suppressed]):
        records.append({
            "pass": f.pass_name,
            "rule": f.rule,
            "file": f"{f.module}.py",
            "line": f.line,
            "location": f"{f.module}.py:{f.line}",
            "context": f.context,
            "message": f.message,
            "suppressed": suppressed,
        })
    records.sort(key=lambda r: (r["file"], r["line"], r["pass"], r["rule"],
                                r["context"], r["message"]))
    return json.dumps({"ok": report.ok, "findings": records},
                      indent=2, sort_keys=True, allow_nan=False)


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static determinism & cache-integrity analysis of "
                    "repro_torch.core (DESIGN.md Section 9).")
    parser.add_argument(
        "--core-dir", type=Path, default=None,
        help="analyze this copy of the repro_torch/core sources instead of the "
             "installed package (mutation tests use this)")
    parser.add_argument(
        "--baseline", type=Path, default=None,
        help="baseline file (default: the checked-in "
             "src/repro_torch/analysis/baseline.json)")
    parser.add_argument(
        "--passes", default=",".join(PASSES),
        help=f"comma-separated subset of {PASSES}")
    parser.add_argument(
        "--write-baseline", action="store_true",
        help="rewrite the baseline to accept all current determinism "
             "findings (preserving reasons of kept entries); new entries "
             "still need a hand-written reason before the run goes green")
    parser.add_argument(
        "--json", action="store_true", dest="as_json",
        help="emit machine-readable findings (stable-sorted records with "
             "file:line, rule id and pass name) instead of the text "
             "report")
    parser.add_argument(
        "-v", "--verbose", action="store_true",
        help="also list baseline-suppressed findings")
    args = parser.parse_args(argv)

    passes = tuple(p.strip() for p in args.passes.split(",") if p.strip())
    unknown = [p for p in passes if p not in PASSES]
    if unknown:
        parser.error(f"unknown pass(es) {unknown}; choose from {PASSES}")

    core_dir = args.core_dir if args.core_dir is not None else CORE_DIR
    if not Path(core_dir, "sweep.py").exists():
        parser.error(f"{core_dir} does not look like repro_torch/core "
                     "(no sweep.py)")

    try:
        findings = run_passes(core_dir, passes)
        baseline = Baseline.load(args.baseline)

        if args.write_baseline:
            old_reasons = {k: r for k, (_, r) in baseline.entries.items()}
            new = Baseline.from_findings(findings, reasons=old_reasons)
            new.dump(args.baseline if args.baseline is not None
                     else baseline.path)
            print(f"baseline rewritten with {len(new.entries)} "
                  "entr(y/ies); fill in empty \"reason\" fields before "
                  "committing")
            baseline = new

        all_baselinable_ran = all(p in passes for p in BASELINABLE_PASSES)
        report = apply_baseline(findings, baseline,
                                check_stale=all_baselinable_ran)
    except Exception:
        # A crash must not be mistakable for "no findings": exit 2, not 0/1.
        traceback.print_exc()
        print("analyzer crashed; this is an analyzer bug, not a finding",
              file=sys.stderr)
        return 2
    if args.as_json:
        print(_json_records(report))
    else:
        out = format_report(report, verbose=args.verbose)
        if out:
            print(out)
    return 0 if report.ok else 1


if __name__ == "__main__":          # pragma: no cover - exercised via -m
    sys.exit(main())
