"""Determinism lints over the schedule-determining modules.

Every cached sweep record and every golden trace assumes that re-running
the same cell under the same seed reproduces the same bytes.  The lints
below flag the constructs that historically break that property.  They are
deliberately *syntactic* (no type inference): a hazard that cannot be
recognized locally is a hazard a reader cannot recognize either, and a
false positive is one baseline entry with a written-down justification
(see :mod:`repro_torch.analysis.report`).

Rules
-----
``unseeded-random``
    Calls into process-global RNG state: ``random.<fn>()`` from the stdlib
    module, or the legacy ``numpy.random.<fn>()`` module-level API.  All
    sanctioned randomness flows through explicitly seeded
    ``np.random.Generator`` objects (``default_rng(SeedSequence(...))``).
``set-iteration``
    Iterating a ``set``/``frozenset`` expression (literal, constructor
    call, or set comprehension) in a ``for``, a comprehension, or an
    order-sensitive/accumulating call (``list``/``tuple``/``sum``/…).
    Set iteration order is salted-hash order and varies across processes —
    exactly the cross-worker poison for a multiprocessing sweep.
    ``sorted(set(...), key=...)`` is flagged too — ties in the sort key
    fall back to set order (Python sorts are stable in *input* order) —
    but key-less ``sorted`` over a set totally orders its distinct
    elements and is allowed.
``dict-popitem``
    ``d.popitem()`` — LIFO over insertion order; almost never the order
    the caller means, and a refactor away from nondeterminism.
``id-in-key``
    ``id(...)`` anywhere in a result path: object identity is an address,
    different every process, so any ordering or keying through it is
    nondeterministic across runs.
``wallclock``
    Reads of real time (``time.time``/``perf_counter``/``monotonic``…,
    ``datetime.now``/``utcnow``/``today``) — fine for logging/stats, fatal
    in anything that feeds a schedule or a cache record.
``uuid``
    ``uuid.uuid1()``/``uuid.uuid4()`` — fresh entropy per call.
``nan-json``
    ``json.dumps``/``json.dump`` without an explicit ``allow_nan=False``:
    NaN-capable floats flowing into cache JSON would serialize as the
    non-standard ``NaN`` token (and NaN != NaN breaks record comparison);
    cache writers must route NaN through an explicit encoding
    (``sweep._nan_to_null``) and keep strict JSON on.
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set

from .importgraph import (
    CORE_DIR,
    expected_fingerprint_sources,
    list_modules,
)
from .report import Finding

#: numpy.random module-level functions that mutate/read the process-global
#: legacy RandomState (np.random.default_rng / Generator / SeedSequence are
#: the sanctioned, explicitly-seeded API and are not listed).
_NP_RANDOM_LEGACY = frozenset({
    "seed", "random", "random_sample", "ranf", "sample", "rand", "randn",
    "randint", "random_integers", "choice", "shuffle", "permutation",
    "bytes", "uniform", "normal", "lognormal", "exponential", "poisson",
    "binomial", "beta", "gamma", "standard_normal", "get_state",
    "set_state",
})

_WALLCLOCK_TIME = frozenset({
    "time", "time_ns", "monotonic", "monotonic_ns", "perf_counter",
    "perf_counter_ns", "process_time", "process_time_ns",
})
_WALLCLOCK_DATETIME = frozenset({"now", "utcnow", "today"})

_ORDER_SENSITIVE_CALLS = frozenset({
    "list", "tuple", "sum", "min", "max", "sorted", "any", "all",
    "enumerate", "map", "filter", "reversed",
})

_UUID_FRESH = frozenset({"uuid1", "uuid4"})


def _is_set_expr(node: ast.AST) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
        return node.func.id in ("set", "frozenset")
    return False


class _Scanner(ast.NodeVisitor):
    def __init__(self, module: str):
        self.module = module
        self.findings: List[Finding] = []
        self._ctx: List[str] = []
        # alias -> canonical module name, for the modules the rules watch.
        self.mod_alias: Dict[str, str] = {}
        # names imported via "from X import y": name -> "X.y"
        self.from_alias: Dict[str, str] = {}

    # ------------------------------------------------------------- helpers
    @property
    def context(self) -> str:
        return ".".join(self._ctx)

    def _emit(self, rule: str, node: ast.AST, message: str) -> None:
        self.findings.append(Finding(
            "determinism", rule, self.module, self.context,
            getattr(node, "lineno", 1), message))

    def _call_target(self, func: ast.AST) -> Optional[str]:
        """Dotted name of a call target, de-aliased, or None.

        ``np.random.rand`` -> "numpy.random.rand" (given ``import numpy
        as np``); ``perf_counter`` -> "time.perf_counter" (given ``from
        time import perf_counter``).
        """
        parts: List[str] = []
        while isinstance(func, ast.Attribute):
            parts.append(func.attr)
            func = func.value
        if isinstance(func, ast.Name):
            root = func.id
            if root in self.mod_alias:
                parts.append(self.mod_alias[root])
            elif root in self.from_alias and not parts:
                return self.from_alias[root]
            elif root in self.from_alias:
                parts.append(self.from_alias[root])
            else:
                parts.append(root)
            return ".".join(reversed(parts))
        return None

    # ------------------------------------------------------------- imports
    def visit_Import(self, node: ast.Import) -> None:
        for alias in node.names:
            name = alias.name
            self.mod_alias[alias.asname or name] = name
        self.generic_visit(node)

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        if node.module and node.level == 0:
            for alias in node.names:
                self.from_alias[alias.asname or alias.name] = \
                    f"{node.module}.{alias.name}"
        self.generic_visit(node)

    # ------------------------------------------------------------- scoping
    def _scoped(self, node) -> None:
        self._ctx.append(node.name)
        self.generic_visit(node)
        self._ctx.pop()

    visit_FunctionDef = _scoped
    visit_AsyncFunctionDef = _scoped
    visit_ClassDef = _scoped

    @staticmethod
    def _is_total_sort(node: ast.Call) -> bool:
        """``sorted(<set>)`` with no ``key=`` totally orders the distinct
        elements — deterministic by construction, so not a finding.  With
        a ``key=``, equal keys tie and stable sort falls back to the
        set's salted-hash order."""
        return (isinstance(node.func, ast.Name)
                and node.func.id == "sorted"
                and not any(k.arg == "key" for k in node.keywords))

    # ------------------------------------------------------------ the rules
    def visit_For(self, node: ast.For) -> None:
        if _is_set_expr(node.iter):
            self._emit("set-iteration", node.iter,
                       "for-loop over a set: iteration order is "
                       "salted-hash order, different across processes")
        self.generic_visit(node)

    def visit_comprehension_iter(self, node) -> None:
        for gen in node.generators:
            if _is_set_expr(gen.iter):
                self._emit("set-iteration", gen.iter,
                           "comprehension over a set: iteration order is "
                           "salted-hash order, different across processes")
        self.generic_visit(node)

    visit_ListComp = visit_comprehension_iter
    visit_GeneratorExp = visit_comprehension_iter
    visit_DictComp = visit_comprehension_iter
    # SetComp iterating a set stays unordered -> not flagged.

    def visit_Call(self, node: ast.Call) -> None:
        target = self._call_target(node.func)
        if target is not None:
            head, _, tail = target.rpartition(".")
            if head == "random":
                # random.Random(seed) / random.SeedSequence-style
                # explicitly-seeded construction is deterministic;
                # only the argless form seeds from OS entropy.
                seeded_ctor = (tail == "Random"
                               and bool(node.args or node.keywords))
                if not seeded_ctor:
                    self._emit("unseeded-random", node,
                               f"random.{tail}() uses the process-global "
                               "stdlib RNG; use an explicitly seeded "
                               "np.random.Generator stream")
            elif head in ("numpy.random", "np.random") \
                    and tail in _NP_RANDOM_LEGACY:
                self._emit("unseeded-random", node,
                           f"numpy.random.{tail}() uses the legacy "
                           "process-global RandomState; use "
                           "default_rng(SeedSequence(...))")
            elif head == "time" and tail in _WALLCLOCK_TIME:
                self._emit("wallclock", node,
                           f"time.{tail}() reads the real clock; results "
                           "must be functions of machine time, not wall "
                           "time")
            elif (head in ("datetime", "datetime.datetime", "datetime.date")
                    and tail in _WALLCLOCK_DATETIME):
                self._emit("wallclock", node,
                           f"{target}() reads the real clock; results "
                           "must be functions of machine time, not wall "
                           "time")
            elif head == "uuid" and tail in _UUID_FRESH:
                self._emit("uuid", node,
                           f"uuid.{tail}() draws fresh entropy per call")
            elif target in ("json.dumps", "json.dump"):
                kw = {k.arg for k in node.keywords}
                if "allow_nan" not in kw:
                    self._emit("nan-json", node,
                               f"{target}() without allow_nan=False: a "
                               "NaN reaching this payload would emit the "
                               "non-standard NaN token into cache/digest "
                               "JSON; encode NaN explicitly and pass "
                               "allow_nan=False")
        if isinstance(node.func, ast.Name):
            if node.func.id in _ORDER_SENSITIVE_CALLS and node.args \
                    and _is_set_expr(node.args[0]) \
                    and not self._is_total_sort(node):
                self._emit("set-iteration", node,
                           f"{node.func.id}() over a set feeds "
                           "order-sensitive output from salted-hash "
                           "iteration order (sorted() ties fall back to "
                           "set order)")
            elif node.func.id == "id" and len(node.args) == 1:
                self._emit("id-in-key", node,
                           "id() is an object address — different every "
                           "process; never let identity feed an order, a "
                           "key, or a record")
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr == "popitem" and not node.args:
            self._emit("dict-popitem", node,
                       "dict.popitem() pops in LIFO insertion order; "
                       "spell the intended order explicitly")
        self.generic_visit(node)


def default_scan_modules(core_dir: Optional[Path] = None) -> List[str]:
    """Modules the determinism pass scans by default: the union of every
    machine's result-determining closure, plus ``sweep`` itself (cache
    keys and records are built there — a nondeterministic key is as stale
    as a nondeterministic record)."""
    mods: Set[str] = {"sweep"}
    for closure in expected_fingerprint_sources(core_dir).values():
        mods |= closure
    return sorted(mods)


#: Repo-level files the pass also lints, as ``(label, directory under the
#: repo root, pattern)``: the port's benchmark modules (they drive cached
#: sweeps) and the port's tests (they pin the reference's bytes) —
#: nondeterminism there corrupts both.  The labels are the reference's, so
#: a finding keys as ``benchmarks/<stem>`` or ``tests/<stem>``.
REPO_SCAN_DIRS = (("benchmarks", "src/repro_torch/benchmarks", "*.py"),
                  ("tests", "tests", "test_torch_*.py"))


def repo_scan_files(core_dir: Path) -> List[tuple]:
    """``(module-label, path)`` for repo-level scan targets.

    Only resolves when ``core_dir`` sits at the canonical
    ``<root>/src/repro_torch/core`` location; ``--core-dir`` scratch trees have
    no surrounding repo and are silently scanned core-only.
    """
    core_dir = Path(core_dir).resolve()
    if core_dir.name != "core" or core_dir.parent.name != "repro_torch" \
            or core_dir.parent.parent.name != "src":
        return []
    root = core_dir.parent.parent.parent
    out = []
    for label, dirname, pattern in REPO_SCAN_DIRS:
        d = root / dirname
        if not d.is_dir():
            continue
        for path in sorted(d.glob(pattern)):
            out.append((f"{label}/{path.stem}", path))
    return out


def scan_determinism(core_dir: Optional[Path] = None,
                     modules: Optional[Sequence[str]] = None
                     ) -> List[Finding]:
    """Run the determinism lints; returns raw (un-baselined) findings."""
    core_dir = Path(core_dir) if core_dir is not None else CORE_DIR
    available = list_modules(core_dir)
    targets: List[tuple] = []
    if modules is None:
        targets = [(m, available[m])
                   for m in default_scan_modules(core_dir)
                   if m in available]
        targets.extend(repo_scan_files(core_dir))
    else:
        targets = [(m, available[m]) for m in modules if m in available]
    findings: List[Finding] = []
    for label, path in targets:
        scanner = _Scanner(label)
        scanner.visit(ast.parse(path.read_text(), filename=str(path)))
        findings.extend(scanner.findings)
    findings.sort(key=lambda f: (f.module, f.line, f.rule))
    return findings


def scan_source(source: str, module: str = "<fixture>") -> List[Finding]:
    """Lint one source string (test fixtures use this)."""
    scanner = _Scanner(module)
    scanner.visit(ast.parse(source))
    return scanner.findings
