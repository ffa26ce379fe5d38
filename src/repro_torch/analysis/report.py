"""Findings, the suppression baseline, and report formatting.

A :class:`Finding` is one analyzer complaint, keyed for suppression by
``rule::module::context`` — deliberately *not* by line number, so a
baselined finding survives unrelated edits to the same file but a second
occurrence of the same hazard in the same function does not slip through
(the baseline stores an occurrence *count* per key).

Only **determinism** findings are baselinable: a nondeterminism hazard can
be a deliberate, justified design choice (the lane executor measures real
wall time; the sweep nonce is a deliberate uniquifier).  Fingerprint
coverage and protocol drift are structural invariants — there is no
justified way to under-cover the cache fingerprint — so those passes
ignore the baseline and always block.

Baseline workflow (DESIGN.md Section 9; README.md, "Static analysis"): fix
the finding, or add an inline justification comment at the site *and* an
entry to this package's own ``baseline.json`` (not the reference's) via
``python -m repro_torch.analysis --write-baseline`` (then fill in the
``reason`` field by hand; empty reasons are themselves findings).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

#: Passes whose findings may be suppressed by the baseline.
BASELINABLE_PASSES = ("determinism", "conformance")

DEFAULT_BASELINE_PATH = Path(__file__).with_name("baseline.json")


@dataclass(frozen=True)
class Finding:
    """One analyzer complaint."""

    pass_name: str          # "fingerprint" | "determinism" | "protocol"
    rule: str               # short rule id, e.g. "wallclock"
    module: str             # repro_torch.core module stem, e.g. "executor"
    context: str            # dotted qualname inside the module ("" = top)
    line: int               # 1-based line in the module source
    message: str

    @property
    def key(self) -> str:
        """Line-independent suppression key."""
        return f"{self.rule}::{self.module}::{self.context}"

    def format(self) -> str:
        where = f"{self.module}.py:{self.line}"
        ctx = f" in {self.context}" if self.context else ""
        return f"[{self.pass_name}/{self.rule}] {where}{ctx}: {self.message}"


@dataclass
class Baseline:
    """Checked-in accepted findings: key -> (count, reason)."""

    entries: Dict[str, Tuple[int, str]] = field(default_factory=dict)
    path: Optional[Path] = None

    @classmethod
    def load(cls, path: Optional[Path] = None) -> "Baseline":
        path = Path(path) if path is not None else DEFAULT_BASELINE_PATH
        if not path.exists():
            return cls(path=path)
        payload = json.loads(path.read_text())
        entries = {
            e["key"]: (int(e.get("count", 1)), e.get("reason", ""))
            for e in payload.get("entries", [])
        }
        return cls(entries=entries, path=path)

    @classmethod
    def from_findings(cls, findings: Sequence[Finding],
                      reasons: Optional[Dict[str, str]] = None) -> "Baseline":
        counts: Dict[str, int] = {}
        for f in findings:
            if f.pass_name in BASELINABLE_PASSES:
                counts[f.key] = counts.get(f.key, 0) + 1
        reasons = reasons or {}
        return cls(entries={k: (n, reasons.get(k, ""))
                            for k, n in counts.items()})

    def dump(self, path: Optional[Path] = None) -> str:
        path = Path(path) if path is not None else self.path
        blob = json.dumps(
            {
                "version": 1,
                "entries": [
                    {"key": k, "count": n, "reason": r}
                    for k, (n, r) in sorted(self.entries.items())
                ],
            },
            indent=2, sort_keys=False, allow_nan=False,
        ) + "\n"
        if path is not None:
            path.write_text(blob)
        return blob


@dataclass
class Report:
    """Outcome of applying the baseline to a batch of findings."""

    blocking: List[Finding]
    suppressed: List[Finding]
    stale_keys: List[str]        # baseline entries that matched nothing
    empty_reasons: List[str]     # baseline entries with no justification

    @property
    def ok(self) -> bool:
        return not self.blocking and not self.empty_reasons


def apply_baseline(findings: Sequence[Finding],
                   baseline: Baseline,
                   check_stale: bool = True) -> Report:
    """Split findings into blocking vs. baseline-suppressed.

    Per key the first ``count`` occurrences are suppressed and any excess
    blocks — so adding a *second* wall-clock read to an already-baselined
    function is a new finding, not a free ride.

    ``check_stale=False`` skips the stale-entry warning: staleness is only
    decidable when every baselinable pass actually ran (a ``--passes``
    subset would otherwise flag entries of the skipped passes).
    """
    budget = {k: n for k, (n, _) in baseline.entries.items()}
    seen = set()
    blocking: List[Finding] = []
    suppressed: List[Finding] = []
    for f in findings:
        if f.pass_name not in BASELINABLE_PASSES:
            blocking.append(f)
            continue
        seen.add(f.key)
        if budget.get(f.key, 0) > 0:
            budget[f.key] -= 1
            suppressed.append(f)
        else:
            blocking.append(f)
    stale = [k for k, (n, _) in sorted(baseline.entries.items())
             if k not in seen] if check_stale else []
    empty = [k for k, (n, r) in sorted(baseline.entries.items())
             if k in seen and not r.strip()]
    return Report(blocking=blocking, suppressed=suppressed,
                  stale_keys=stale, empty_reasons=empty)


def format_report(report: Report, verbose: bool = False) -> str:
    lines: List[str] = []
    for f in report.blocking:
        lines.append(f.format())
    for key in report.empty_reasons:
        lines.append(f"[baseline] entry {key!r} has no justification "
                     "(fill in its \"reason\" field)")
    if verbose:
        for f in report.suppressed:
            lines.append(f"(baselined) {f.format()}")
    for key in report.stale_keys:
        lines.append(f"warning: stale baseline entry {key!r} matched "
                     "nothing (remove it)")
    n_block = len(report.blocking) + len(report.empty_reasons)
    lines.append(
        f"{n_block} blocking finding(s), "
        f"{len(report.suppressed)} baselined, "
        f"{len(report.stale_keys)} stale baseline entr(y/ies)")
    return "\n".join(lines)
