"""Static determinism & cache-integrity analysis for ``repro_torch.core``.

Three AST passes guard the invariants every reported number rests on
(DESIGN.md Section 9):

* :mod:`repro_torch.analysis.importgraph` — the sweep-cache code fingerprint
  (``sweep._FINGERPRINT_SOURCES``) must equal the transitive
  import-closure of each machine's result-determining entry points;
* :mod:`repro_torch.analysis.determinism` — nondeterminism lints (unseeded
  RNGs, set-iteration order, wall-clock reads, NaN-capable JSON, …) over
  the schedule-determining modules, with a checked-in justification
  baseline (:mod:`repro_torch.analysis.report`);
* :mod:`repro_torch.analysis.protocol` — declared contracts vs. actual ASTs:
  Policy hint flags, the fused/typed ``SchedulerCore`` dispatch pair, and
  full Machine-protocol signatures.

Three more passes verify the compiled DES engine trio (DESIGN.md
Section 11):

* :mod:`repro_torch.analysis.conformance` — ``fastsim_twin`` stays inside the
  nopython subset all three backends execute identically;
* :mod:`repro_torch.analysis.translate` — twin and generated-C functions lower
  to the same normalized IR (control-flow skeleton + operation bags),
  plus constant-drift / FMA-contraction / int-division / narrowed-dtype
  lints on the C side;
* :mod:`repro_torch.analysis.layout` — field tables, allocation widths, C
  accessor strides, the 29-array state order, and the buffer-growth
  exit wiring all agree.

Run it as ``python -m repro_torch.analysis`` (``chip_smoke.py``'s last phase does).
The package never imports ``repro_torch.core`` — everything is file-level AST,
so it can analyze mutated copies of the tree (and the heavy simulator
stack never loads just to lint).
"""

from __future__ import annotations

from .cli import PASSES, main, run_passes
from .conformance import scan_conformance
from .determinism import (
    default_scan_modules,
    scan_determinism,
    scan_source,
)
from .layout import scan_layout
from .importgraph import (
    ENTRY_POINTS,
    NON_RESULT_MODULES,
    build_import_graph,
    check_fingerprint_coverage,
    expected_fingerprint_sources,
    load_fingerprint_table,
    transitive_closure,
)
from .protocol import (
    check_fused_paths,
    check_machine_signatures,
    check_policy_hints,
    check_protocols,
)
from .report import (
    Baseline,
    Finding,
    Report,
    apply_baseline,
    format_report,
)
from .translate import FuncSummary, scan_translation

__all__ = [
    "Baseline",
    "ENTRY_POINTS",
    "Finding",
    "FuncSummary",
    "NON_RESULT_MODULES",
    "PASSES",
    "Report",
    "apply_baseline",
    "build_import_graph",
    "check_fingerprint_coverage",
    "check_fused_paths",
    "check_machine_signatures",
    "check_policy_hints",
    "check_protocols",
    "default_scan_modules",
    "expected_fingerprint_sources",
    "format_report",
    "load_fingerprint_table",
    "main",
    "run_passes",
    "scan_conformance",
    "scan_determinism",
    "scan_layout",
    "scan_source",
    "scan_translation",
    "transitive_closure",
]
