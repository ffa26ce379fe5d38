"""Fingerprint-coverage pass: import graph vs. ``_FINGERPRINT_SOURCES``.

The sweep cache is content-addressed and every key embeds a *code
fingerprint* — a digest of the source files whose behavior the cached
record depends on (``repro_torch.core.sweep._FINGERPRINT_SOURCES``).  The table
is hand-maintained, and its failure mode is silent: forget to list a
module that affects schedules and the cache happily serves records
computed by old code.

This pass closes that hole statically.  For each machine it computes the
transitive closure of ``repro_torch.core``-internal imports from the machine's
*result-determining entry points* and demands that the fingerprint table
equals the closure exactly:

* a closure module missing from the table is **under-coverage** (stale
  cache served — the dangerous direction),
* a table module outside the closure is a **stale entry** (pointless
  invalidation — the annoying direction),
* a ``repro_torch.core`` module in neither any closure nor the explicit
  :data:`NON_RESULT_MODULES` allowlist is **unclassified** — every new
  module must declare which side it is on before CI passes.

The closure is an over-approximation by construction (a module-level
import counts even if the imported code cannot run on that machine's
path); that is the right direction for a cache key — over-invalidation
merely recomputes.

Everything here is pure AST over file contents: nothing from
``repro_torch.core`` is imported, so the pass can run against a mutated copy of
the tree (the mutation tests do exactly that).

``scenarios.executor_job`` imports the device resolver from the package
root (``from .. import resolve_device``): that import leaves
``repro_torch.core`` and, like any import outside the package, the closure
does not follow it; the device it resolves is folded into the executor
cache keys (``sweep._device_name``).
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

from .report import Finding

#: The real package this analyzer guards.
CORE_DIR = Path(__file__).resolve().parents[1] / "core"

CORE_PACKAGE = "repro_torch.core"

#: Result-determining entry points per machine (module stems).  The
#: machine's own driver module plus everything a sweep cell's *record*
#: content is computed from: the policy and predictor implementations the
#: cell names, the metrics evaluated into the record, and — for scenario
#: cells — the arrival-process code.  distrib.py — the cell
#: runners + record store every dispatcher executes through — is an entry
#: point of every machine: a record's bytes are shaped there (window
#: evaluation, NaN encoding, serialization), whichever dispatcher and
#: whichever host produced it.
ENTRY_POINTS: Dict[str, Tuple[str, ...]] = {
    "des": ("simulator", "policies", "predictor", "metrics", "distrib"),
    "des-closed": ("simulator", "policies", "predictor", "metrics",
                   "scenarios", "distrib"),
    "executor": ("executor", "policies", "predictor", "metrics",
                 "scenarios", "distrib"),
}

#: Modules that are deliberately *not* result-determining, with the reason
#: each is safe to leave out of every fingerprint.  A module missing from
#: both this table and every closure fails the pass (see module docstring).
NON_RESULT_MODULES: Dict[str, str] = {
    "__init__": "re-export surface only; importing it runs no cell logic",
    "sweep": "cache-key construction and orchestration; record-shaping "
             "edits here must bump CACHE_VERSION instead (DESIGN.md "
             "Section 9)",
    "jobs": "launch-tier job builders; consumed by benchmarks and the "
            "service frontend, never imported by a sweep cell",
    "scheduler_service": "async frontend over the executor; wraps "
                         "machines, does not alter what they compute",
}

FINGERPRINT_TABLE_NAME = "_FINGERPRINT_SOURCES"


def list_modules(core_dir: Optional[Path] = None) -> Dict[str, Path]:
    """Map module stem -> path for every ``repro_torch.core`` source file."""
    core_dir = Path(core_dir) if core_dir is not None else CORE_DIR
    return {p.stem: p for p in sorted(core_dir.glob("*.py"))}


def module_imports(path: Path, known: FrozenSet[str]) -> Set[str]:
    """Stems of ``repro_torch.core`` modules imported anywhere in ``path``.

    Function-local and conditional imports count: they execute on some
    path, and the closure must over- rather than under-approximate.
    """
    tree = ast.parse(path.read_text(), filename=str(path))
    edges: Set[str] = set()
    prefix = CORE_PACKAGE + "."
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name.startswith(prefix):
                    stem = alias.name[len(prefix):].split(".")[0]
                    if stem in known:
                        edges.add(stem)
        elif isinstance(node, ast.ImportFrom):
            if node.level == 1 and node.module:
                stem = node.module.split(".")[0]
                if stem in known:
                    edges.add(stem)
            elif node.level == 1 and node.module is None:
                for alias in node.names:        # from . import simulator
                    if alias.name in known:
                        edges.add(alias.name)
            elif node.level == 0 and node.module:
                if node.module == CORE_PACKAGE:
                    for alias in node.names:
                        if alias.name in known:
                            edges.add(alias.name)
                elif node.module.startswith(prefix):
                    stem = node.module[len(prefix):].split(".")[0]
                    if stem in known:
                        edges.add(stem)
    return edges


def build_import_graph(core_dir: Optional[Path] = None
                       ) -> Dict[str, Set[str]]:
    """Intra-package import graph: module stem -> imported stems."""
    modules = list_modules(core_dir)
    known = frozenset(modules)
    return {stem: module_imports(path, known)
            for stem, path in modules.items()}


def transitive_closure(graph: Dict[str, Set[str]],
                       roots: Tuple[str, ...]) -> Set[str]:
    closure: Set[str] = set()
    stack: List[str] = [r for r in roots if r in graph]
    while stack:
        mod = stack.pop()
        if mod in closure:
            continue
        closure.add(mod)
        stack.extend(graph.get(mod, ()))
    return closure


def expected_fingerprint_sources(core_dir: Optional[Path] = None
                                 ) -> Dict[str, Set[str]]:
    """The closure each machine's fingerprint tuple must equal."""
    graph = build_import_graph(core_dir)
    return {machine: transitive_closure(graph, roots)
            for machine, roots in ENTRY_POINTS.items()}


def load_fingerprint_table(core_dir: Optional[Path] = None
                           ) -> Optional[Dict[str, Tuple[str, ...]]]:
    """Statically read ``_FINGERPRINT_SOURCES`` from ``sweep.py``.

    Returns None when the assignment is missing or not a literal dict —
    both are coverage findings, reported by :func:`check_fingerprint_coverage`.
    """
    core_dir = Path(core_dir) if core_dir is not None else CORE_DIR
    sweep_path = core_dir / "sweep.py"
    if not sweep_path.exists():
        return None
    tree = ast.parse(sweep_path.read_text(), filename=str(sweep_path))
    for node in tree.body:
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets = [node.target]
        for target in targets:
            if (isinstance(target, ast.Name)
                    and target.id == FINGERPRINT_TABLE_NAME):
                try:
                    value = ast.literal_eval(node.value)
                except ValueError:
                    return None
                if not isinstance(value, dict):
                    return None
                return {str(k): tuple(v) for k, v in value.items()}
    return None


def check_fingerprint_coverage(core_dir: Optional[Path] = None
                               ) -> List[Finding]:
    """The fingerprint-coverage pass (see module docstring)."""
    core_dir = Path(core_dir) if core_dir is not None else CORE_DIR
    findings: List[Finding] = []

    def finding(rule: str, module: str, message: str) -> None:
        findings.append(Finding("fingerprint", rule, module, "", 1, message))

    modules = list_modules(core_dir)
    table = load_fingerprint_table(core_dir)
    if table is None:
        finding("table-unreadable", "sweep",
                f"{FINGERPRINT_TABLE_NAME} is missing from sweep.py or is "
                "not a literal dict; the coverage pass cannot verify it")
        return findings

    expected = expected_fingerprint_sources(core_dir)

    for machine in sorted(set(expected) | set(table)):
        if machine not in table:
            finding("machine-missing", "sweep",
                    f"machine {machine!r} has analyzer entry points but no "
                    f"{FINGERPRINT_TABLE_NAME} entry")
            continue
        if machine not in expected:
            finding("machine-unknown", "sweep",
                    f"{FINGERPRINT_TABLE_NAME} lists machine {machine!r} "
                    "unknown to the analyzer; add its entry points to "
                    "repro_torch.analysis.importgraph.ENTRY_POINTS")
            continue
        declared = set(table[machine])
        closure = expected[machine]
        for mod in sorted(closure - declared):
            finding("under-coverage", mod,
                    f"{mod}.py is reachable from {machine!r} entry points "
                    f"{ENTRY_POINTS[machine]} but absent from "
                    f"{FINGERPRINT_TABLE_NAME}[{machine!r}]: edits to it "
                    "would silently serve stale cached results")
        for mod in sorted(declared - closure):
            finding("stale-entry", mod,
                    f"{FINGERPRINT_TABLE_NAME}[{machine!r}] lists {mod}.py "
                    "which is not reachable from that machine's entry "
                    "points; remove it or add the missing import edge")
        for mod in sorted(declared - set(modules)):
            finding("missing-file", mod,
                    f"{FINGERPRINT_TABLE_NAME}[{machine!r}] lists {mod}.py "
                    "which does not exist in repro_torch/core")

    classified: Set[str] = set(NON_RESULT_MODULES)
    for closure in expected.values():
        classified |= closure
    for mod in sorted(set(modules) - classified):
        finding("unclassified-module", mod,
                f"{mod}.py is neither reachable from any machine's entry "
                "points nor declared in NON_RESULT_MODULES; classify it "
                "(result-determining modules must be imported by an entry "
                "point; others need an allowlist entry with a reason)")
    for mod in sorted(set(NON_RESULT_MODULES) - set(modules) - {"__init__"}):
        finding("stale-allowlist", mod,
                f"NON_RESULT_MODULES lists {mod}.py which does not exist")
    return findings
