"""Nopython-subset conformance for the engine twin.

``fastsim_twin.py`` must stay inside the language subset that all three
backends execute identically: numba's nopython mode, and — stricter —
the C89-ish dialect :mod:`repro_torch.core.fastsim_c` mirrors function for
function.  Anything outside the subset is a finding, so a convenient
Python-ism (a dict, a slice, a generator, an f-string) cannot creep into
the twin and silently diverge the interpreted backend from the other
two.

The subset, by construction from what the C translation can express:

* statements — plain/augmented assignment, ``if``/``elif``/``else``,
  ``while``, ``for .. in range(..)``, ``return``, ``break``,
  ``continue``, ``pass``, expression-statement calls;
* expressions — int/float/bool constants, scalar names, single
  comparisons, ``+ - * / // % << >>``, ``and``/``or``/``not``, unary
  minus, conditional expressions, flat array subscripts (no slices),
  tuples only for multi-assignment/return/indexing;
* calls — ``range``, ``int``, ``math.floor``, other ``@_jit`` functions,
  and ``np.empty``/``np.zeros`` with an explicit ``np.int64`` /
  ``np.float64`` dtype;
* signatures — plain positional parameters only (no defaults, ``*``,
  ``**``, keyword-only);
* module level — every function is ``@_jit`` except the documented
  dispatch shims.

The pass is baselinable (``conformance`` is in
:data:`repro_torch.analysis.report.BASELINABLE_PASSES`): a deliberate,
justified exception can be suppressed in ``baseline.json``, but it must
carry a reason a maintainer can audit.
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import List, Set

from .enginesrc import load_twin_ast, twin_jit_functions, twin_path
from .report import Finding

PASS = "conformance"

_MODULE = "fastsim_twin"

#: Module-level functions that are dispatch plumbing, not kernel code.
_UNJITTED_ALLOWED = {"_identity"}

_ALLOWED_BINOPS = (ast.Add, ast.Sub, ast.Mult, ast.Div, ast.FloorDiv,
                   ast.Mod, ast.LShift, ast.RShift)
_ALLOWED_CMPOPS = (ast.Eq, ast.NotEq, ast.Lt, ast.LtE, ast.Gt, ast.GtE)
_ALLOWED_UNARY = (ast.USub, ast.Not)

_NAME_CALLS = {"range", "int"}
_MATH_CALLS = {"floor"}
_NP_ALLOC_CALLS = {"empty", "zeros"}
_NP_DTYPES = {"int64", "float64"}


class _SubsetChecker:
    def __init__(self, fn: ast.FunctionDef, jit_names: Set[str]):
        self.fn = fn
        self.jit_names = jit_names
        self.findings: List[Finding] = []

    def _flag(self, rule: str, line: int, message: str) -> None:
        self.findings.append(
            Finding(PASS, rule, _MODULE, self.fn.name, line, message))

    def run(self) -> List[Finding]:
        args = self.fn.args
        if (args.defaults or args.kw_defaults or args.vararg
                or args.kwarg or args.kwonlyargs or args.posonlyargs):
            self._flag("subset-signature", self.fn.lineno,
                       "only plain positional parameters are portable "
                       "across the numba and C backends")
        self._block(self.fn.body, top=True)
        return self.findings

    # -- statements
    def _block(self, stmts, top: bool = False) -> None:
        for i, s in enumerate(stmts):
            self._stmt(s, docstring_ok=top and i == 0)

    def _stmt(self, s: ast.stmt, docstring_ok: bool = False) -> None:
        if isinstance(s, ast.Expr):
            if (docstring_ok and isinstance(s.value, ast.Constant)
                    and isinstance(s.value.value, str)):
                return
            if isinstance(s.value, ast.Call):
                self._expr(s.value)
                return
            self._flag("subset-node", s.lineno,
                       "bare non-call expression statement")
            return
        if isinstance(s, ast.Assign):
            for t in s.targets:
                self._target(t)
            self._expr(s.value)
            return
        if isinstance(s, ast.AugAssign):
            if not isinstance(s.op, _ALLOWED_BINOPS):
                self._flag("subset-node", s.lineno,
                           f"augmented operator {type(s.op).__name__} "
                           f"outside the portable subset")
            self._target(s.target)
            self._expr(s.value)
            return
        if isinstance(s, ast.If):
            self._expr(s.test)
            self._block(s.body)
            self._block(s.orelse)
            return
        if isinstance(s, ast.While):
            if s.orelse:
                self._flag("subset-node", s.lineno, "while-else clause")
            self._expr(s.test)
            self._block(s.body)
            return
        if isinstance(s, ast.For):
            if s.orelse:
                self._flag("subset-node", s.lineno, "for-else clause")
            if not (isinstance(s.iter, ast.Call)
                    and isinstance(s.iter.func, ast.Name)
                    and s.iter.func.id == "range"
                    and 1 <= len(s.iter.args) <= 2
                    and not s.iter.keywords):
                self._flag("subset-node", s.lineno,
                           "for loops must iterate a 1- or 2-argument "
                           "range() so the C translation is a counted for")
            else:
                for a in s.iter.args:
                    self._expr(a)
            if not isinstance(s.target, ast.Name):
                self._flag("subset-node", s.lineno,
                           "loop target must be a plain name")
            self._block(s.body)
            return
        if isinstance(s, ast.Return):
            if s.value is not None:
                if isinstance(s.value, ast.Tuple):
                    for e in s.value.elts:
                        self._expr(e)
                else:
                    self._expr(s.value)
            return
        if isinstance(s, (ast.Break, ast.Continue, ast.Pass)):
            return
        self._flag("subset-node", s.lineno,
                   f"statement {type(s).__name__} outside the portable "
                   f"subset")

    def _target(self, t: ast.expr) -> None:
        if isinstance(t, ast.Name):
            return
        if isinstance(t, ast.Tuple):
            for e in t.elts:
                if not isinstance(e, ast.Name):
                    self._flag("subset-node", t.lineno,
                               "tuple-assignment elements must be names")
            return
        if isinstance(t, ast.Subscript):
            self._subscript(t)
            return
        self._flag("subset-node", t.lineno,
                   f"assignment target {type(t).__name__} outside the "
                   f"portable subset")

    # -- expressions
    def _expr(self, e: ast.expr) -> None:
        if isinstance(e, ast.Constant):
            if not isinstance(e.value, (int, float, bool)):
                self._flag("subset-node", e.lineno,
                           f"constant {e.value!r} is not a portable "
                           f"scalar")
            return
        if isinstance(e, ast.Name):
            return
        if isinstance(e, ast.Attribute):
            if isinstance(e.value, ast.Name):
                if e.value.id == "math" and e.attr in ("nan", "inf"):
                    return
                if e.value.id == "np" and e.attr in _NP_DTYPES:
                    return
            self._flag("subset-node", e.lineno,
                       f"attribute access {ast.unparse(e)} outside the "
                       f"portable subset")
            return
        if isinstance(e, ast.Subscript):
            self._subscript(e)
            return
        if isinstance(e, ast.BinOp):
            if not isinstance(e.op, _ALLOWED_BINOPS):
                self._flag("subset-node", e.lineno,
                           f"operator {type(e.op).__name__} outside the "
                           f"portable subset")
            self._expr(e.left)
            self._expr(e.right)
            return
        if isinstance(e, ast.BoolOp):
            for v in e.values:
                self._expr(v)
            return
        if isinstance(e, ast.UnaryOp):
            if not isinstance(e.op, _ALLOWED_UNARY):
                self._flag("subset-node", e.lineno,
                           f"unary {type(e.op).__name__} outside the "
                           f"portable subset")
            self._expr(e.operand)
            return
        if isinstance(e, ast.Compare):
            if len(e.ops) != 1:
                self._flag("subset-node", e.lineno,
                           "chained comparisons have no C counterpart; "
                           "split into and-ed comparisons")
            for op in e.ops:
                if not isinstance(op, _ALLOWED_CMPOPS):
                    self._flag("subset-node", e.lineno,
                               f"comparison {type(op).__name__} outside "
                               f"the portable subset")
            self._expr(e.left)
            for c in e.comparators:
                self._expr(c)
            return
        if isinstance(e, ast.IfExp):
            self._expr(e.test)
            self._expr(e.body)
            self._expr(e.orelse)
            return
        if isinstance(e, ast.Call):
            self._call(e)
            return
        self._flag("subset-node", e.lineno,
                   f"expression {type(e).__name__} outside the portable "
                   f"subset")

    def _subscript(self, e: ast.Subscript) -> None:
        if not isinstance(e.value, ast.Name):
            self._flag("subset-node", e.lineno,
                       "subscript base must be a plain array name")
        idx = e.slice
        dims = idx.elts if isinstance(idx, ast.Tuple) else [idx]
        for d in dims:
            if isinstance(d, (ast.Slice,)):
                self._flag("subset-node", e.lineno,
                           "slicing has no flat-array C counterpart; "
                           "index elementwise")
            else:
                self._expr(d)

    def _call(self, e: ast.Call) -> None:
        if e.keywords:
            self._flag("subset-call", e.lineno,
                       "keyword arguments are not portable; pass "
                       "positionally")
        func = e.func
        if isinstance(func, ast.Name):
            if func.id in _NAME_CALLS or func.id in self.jit_names:
                for a in e.args:
                    self._expr(a)
                return
            self._flag("subset-call", e.lineno,
                       f"call to {func.id}() — only range/int, math.floor, "
                       f"np.empty/np.zeros and other @_jit functions are "
                       f"portable")
            return
        if isinstance(func, ast.Attribute) and isinstance(
                func.value, ast.Name):
            base, attr = func.value.id, func.attr
            if base == "math" and attr in _MATH_CALLS:
                for a in e.args:
                    self._expr(a)
                return
            if base == "np" and attr in _NP_ALLOC_CALLS:
                self._np_alloc(e)
                return
            self._flag("subset-call", e.lineno,
                       f"call to {base}.{attr}() outside the portable "
                       f"subset")
            return
        self._flag("subset-call", e.lineno,
                   "computed call target outside the portable subset")

    def _np_alloc(self, e: ast.Call) -> None:
        if len(e.args) != 2:
            self._flag("subset-dtype", e.lineno,
                       "np.empty/np.zeros in kernel code must pass an "
                       "explicit dtype (np.int64 or np.float64)")
            return
        shape, dtype = e.args
        dims = shape.elts if isinstance(shape, ast.Tuple) else [shape]
        for d in dims:
            self._expr(d)
        if not (isinstance(dtype, ast.Attribute)
                and isinstance(dtype.value, ast.Name)
                and dtype.value.id == "np" and dtype.attr in _NP_DTYPES):
            self._flag("subset-dtype", e.lineno,
                       "kernel allocations must use np.int64 or "
                       "np.float64 — anything else diverges from the "
                       "int64/float64 C world")


def scan_conformance(core_dir: Path) -> List[Finding]:
    core_dir = Path(core_dir)
    if not twin_path(core_dir).exists():
        return []
    tree = load_twin_ast(core_dir)
    jit_fns = twin_jit_functions(tree)
    jit_names: Set[str] = set()
    for fn in jit_fns:
        jit_names.add(fn.name)
        jit_names.add(fn.name.lstrip("_"))

    findings: List[Finding] = []
    for node in tree.body:
        if isinstance(node, ast.FunctionDef):
            if node in jit_fns or node.name in _UNJITTED_ALLOWED:
                continue
            findings.append(Finding(
                PASS, "unjitted-function", _MODULE, node.name, node.lineno,
                f"module-level function {node.name} lacks @_jit; kernel "
                f"code outside the jit set runs interpreted-only and "
                f"cannot be mirrored to C"))
        elif isinstance(node, ast.ClassDef):
            findings.append(Finding(
                PASS, "subset-node", _MODULE, node.name, node.lineno,
                "classes are outside the nopython kernel subset"))
    for fn in jit_fns:
        findings.extend(_SubsetChecker(fn, jit_names).run())
    return findings
