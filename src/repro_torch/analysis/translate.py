"""Translation validator: the Python twin vs. the generated C backend.

``fastsim_twin.py`` and ``fastsim_c.py`` are maintained as a
function-for-function pair; the runtime equivalence matrix (DESIGN.md
Section 10) samples their agreement, but a *sampled* gate can miss an
unmirrored edit.  This pass lowers both sides into a shared normalized
summary per function and fails on any structural disagreement.

Normalized IR (per function) — deliberately *bag-based* rather than a
lockstep tree diff, so that C idioms the translation legitimately uses
(declaration hoisting, one-sided temporaries for repeated reads, block
scoping) do not produce noise:

* ``params``   — parameter count after dropping the state arrays / ``S``.
* ``skeleton`` — *ordered* control-flow string: counted loops ``L{..}``,
  ``while (1)`` / ``while True`` loops ``F{..}``, other whiles
  ``W{..}``, conditionals ``I{..}E{..}``, ``return`` ``R<arity>``,
  ``break``/``continue`` ``B``/``C``.  Straight-line assignments and
  calls are invisible.
* ``compares`` / ``binops`` / ``selects`` / ``loops`` / ``calls`` /
  ``writes`` — *multisets* of operation signatures where operands
  collapse to a constant value or the wildcard ``x``.
* ``reads`` — a *set* (not multiset) of array-read signatures with the
  index rendered symbolically; set semantics make C-side caching of a
  repeated read into a temporary invisible.
* ``local_arrays`` — shapes/dtypes of function-local scratch arrays.

Scalar assignments are not recorded at all: a temporary only matters
through the reads/ops/writes it feeds, which the bags already capture.
Constants are folded through the twin's module constants, so renaming a
``#define`` or drifting its value surfaces as a bag or constant-drift
mismatch rather than hiding behind a name.

On top of the pair diff, C-side-only lints cover the places where a
structurally identical translation could still diverge numerically:
``-ffp-contract=off`` must stay in the build line while FMA-able
``a*b+c`` float shapes exist (rule ``fma-contract``), C ``/`` must never
see two int operands since Python ``/`` is true division and ``//``
floors while C truncates (rule ``int-division``), and every declared
scalar must be ``int64_t``/``double`` so no implicit narrowing can bite
(rule ``narrowed-dtype``).
"""

from __future__ import annotations

import ast
import math
from collections import Counter
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from . import cparse
from .cparse import (CAssign, CBreak, CContinue, CDecl, CExprStmt, CFor,
                     CFunc, CIf, CParseError, CReturn, CUnit, CWhile)
from .enginesrc import (ARRAY_DTYPES, C_CONST_ALIASES, CANONICAL_ARRAYS,
                        c_path, fold_twin_constants, load_twin_ast,
                        pair_name, parse_c_unit, twin_jit_functions,
                        twin_path)
from .report import Finding

PASS = "translate"

_TWIN_MODULE = "fastsim_twin"
_C_MODULE = "fastsim_c"

#: C scalar declaration types that match the twin's int64/float64 world.
_WIDE_TYPES = {"int64_t", "double"}

#: ``int`` is tolerated for pure boolean/flag locals (values in {0,1},
#: never fed into arithmetic); anything else narrows.
_BOOL_OK_TYPE = "int"

_ARITH_OPS = {"+", "-", "*", "/", "%", "<<", ">>"}


# ------------------------------------------------------------- summaries
@dataclass
class FuncSummary:
    name: str
    line: int = 0
    params: int = 0
    skeleton: str = ""
    loops: Counter = field(default_factory=Counter)
    compares: Counter = field(default_factory=Counter)
    binops: Counter = field(default_factory=Counter)
    selects: Counter = field(default_factory=Counter)
    calls: Counter = field(default_factory=Counter)
    writes: Counter = field(default_factory=Counter)
    returns: Counter = field(default_factory=Counter)
    reads: set = field(default_factory=set)
    local_arrays: Counter = field(default_factory=Counter)

    _BAGS = ("loops", "compares", "binops", "selects", "calls", "writes",
             "returns", "local_arrays")

    def diff(self, other: "FuncSummary") -> List[str]:
        """Human-readable mismatch descriptions (empty = equivalent)."""
        out: List[str] = []
        if self.params != other.params:
            out.append(f"parameter count {self.params} vs {other.params}")
        if self.skeleton != other.skeleton:
            out.append(f"control-flow skeleton {self.skeleton!r} vs "
                       f"{other.skeleton!r}")
        for bag in self._BAGS:
            a: Counter = getattr(self, bag)
            b: Counter = getattr(other, bag)
            if a != b:
                only_a = sorted((a - b).elements())
                only_b = sorted((b - a).elements())
                parts = []
                if only_a:
                    parts.append("twin-only " + ", ".join(only_a[:4]))
                if only_b:
                    parts.append("c-only " + ", ".join(only_b[:4]))
                out.append(f"{bag} bag: " + "; ".join(parts))
        if self.reads != other.reads:
            only_a = sorted(self.reads - other.reads)
            only_b = sorted(other.reads - self.reads)
            parts = []
            if only_a:
                parts.append("twin-only " + ", ".join(only_a[:4]))
            if only_b:
                parts.append("c-only " + ", ".join(only_b[:4]))
            out.append("reads set: " + "; ".join(parts))
        return out


def _const_repr(value) -> str:
    if isinstance(value, float):
        if math.isnan(value):
            return "NAN"
        if math.isinf(value):
            return "INF" if value > 0 else "-INF"
        if value == int(value) and abs(value) < 1e15:
            # 1.0 and 1 must not depend on which side spelled the literal
            # with a dot; the engine is all-float64/int64 anyway.
            return str(int(value))
        return repr(value)
    return str(value)


_CMP_MIRROR = {"<": ">", "<=": ">=", ">": "<", ">=": "<=",
               "==": "==", "!=": "!="}


def _cmp_sig(op: str, left: str, right: str) -> str:
    """Orientation-normalized comparison signature.

    ``a < b`` and ``b > a`` are the same comparison; pick the
    lexicographically smaller rendering so both sides agree regardless
    of how the translation oriented it.
    """
    a = f"({op},{left},{right})"
    b = f"({_CMP_MIRROR[op]},{right},{left})"
    return min(a, b)


_COMMUTATIVE = {"+", "*"}


def _bin_sig(op: str, left: str, right: str) -> str:
    if op in _COMMUTATIVE and right < left:
        left, right = right, left
    return f"({op},{left},{right})"


# ------------------------------------------------------- twin normalizer
_PY_BINOPS = {ast.Add: "+", ast.Sub: "-", ast.Mult: "*", ast.Div: "/",
              ast.FloorDiv: "//", ast.Mod: "%", ast.LShift: "<<",
              ast.RShift: ">>"}
_PY_CMPOPS = {ast.Eq: "==", ast.NotEq: "!=", ast.Lt: "<", ast.LtE: "<=",
              ast.Gt: ">", ast.GtE: ">="}


class TwinNormalizeError(Exception):
    def __init__(self, message: str, line: int = 0):
        super().__init__(message)
        self.line = line


class _TwinNormalizer:
    """Lower one ``@_jit`` twin function into a :class:`FuncSummary`."""

    def __init__(self, fn: ast.FunctionDef, consts: Dict[str, object]):
        self.fn = fn
        self.consts = consts
        self.summary = FuncSummary(name=fn.name, line=fn.lineno)
        self.aliases: Dict[str, str] = {}   # local name -> canonical array
        self.local_arrays: Dict[str, str] = {}
        params = [a.arg for a in fn.args.args]
        self.state_param = "S" if "S" in params else None
        for p in params:
            if p in CANONICAL_ARRAYS:
                self.aliases[p] = p
        self.summary.params = len([
            p for p in params if p != "S" and p not in CANONICAL_ARRAYS])

    def run(self) -> FuncSummary:
        self.summary.skeleton = self._block(self.fn.body)
        return self.summary

    # -- statements -> skeleton fragments
    def _block(self, stmts: Sequence[ast.stmt]) -> str:
        return "".join(self._stmt(s) for s in stmts)

    def _stmt(self, s: ast.stmt) -> str:
        if isinstance(s, ast.Expr):
            if isinstance(s.value, ast.Constant) and isinstance(
                    s.value.value, str):
                return ""      # docstring
            self._expr(s.value)
            return ""
        if isinstance(s, ast.Assign):
            return self._assign(s)
        if isinstance(s, ast.AugAssign):
            op = _PY_BINOPS.get(type(s.op))
            if op is None:
                raise TwinNormalizeError(
                    f"unsupported augmented op {type(s.op).__name__}",
                    s.lineno)
            target_kind = self._expr(s.target, write=True)
            value_kind = self._expr(s.value)
            self.summary.binops[_bin_sig(op, target_kind, value_kind)] += 1
            return ""
        if isinstance(s, ast.If):
            self._expr(s.test)
            frag = "I{" + self._block(s.body) + "}"
            if s.orelse:
                frag += "E{" + self._block(s.orelse) + "}"
            return frag
        if isinstance(s, ast.While):
            if isinstance(s.test, ast.Constant) and s.test.value is True:
                return "F{" + self._block(s.body) + "}"
            self._expr(s.test)
            return "W{" + self._block(s.body) + "}"
        if isinstance(s, ast.For):
            return self._for(s)
        if isinstance(s, ast.Return):
            return self._return(s)
        if isinstance(s, ast.Break):
            return "B"
        if isinstance(s, ast.Continue):
            return "C"
        if isinstance(s, ast.Pass):
            return ""
        raise TwinNormalizeError(
            f"unsupported statement {type(s).__name__}", s.lineno)

    def _assign(self, s: ast.Assign) -> str:
        if len(s.targets) != 1:
            raise TwinNormalizeError("chained assignment", s.lineno)
        target = s.targets[0]
        if isinstance(target, ast.Name):
            # State-unpack prologue: ``si = S[0]`` binds an alias.
            if (self.state_param and isinstance(s.value, ast.Subscript)
                    and isinstance(s.value.value, ast.Name)
                    and s.value.value.id == self.state_param
                    and isinstance(s.value.slice, ast.Constant)):
                idx = s.value.slice.value
                if isinstance(idx, int) and 0 <= idx < len(CANONICAL_ARRAYS):
                    self.aliases[target.id] = CANONICAL_ARRAYS[idx]
                    return ""
            arr = self._np_empty(s.value)
            if arr is not None:
                label = f"local{len(self.local_arrays)}"
                self.local_arrays[target.id] = label
                self.summary.local_arrays[f"{label}{arr}"] += 1
                return ""
            self._expr(s.value)
            return ""
        if isinstance(target, ast.Tuple):
            if not all(isinstance(e, ast.Name) for e in target.elts):
                raise TwinNormalizeError("complex tuple target", s.lineno)
            self._expr(s.value)
            return ""
        if isinstance(target, (ast.Subscript,)):
            self._expr(target, write=True)
            self._expr(s.value)
            return ""
        raise TwinNormalizeError(
            f"unsupported assignment target {type(target).__name__}",
            s.lineno)

    def _np_empty(self, e: ast.expr) -> Optional[str]:
        """``np.empty((d0, d1), np.int64)`` -> ``(d0,d1):i`` signature."""
        if not (isinstance(e, ast.Call) and isinstance(e.func, ast.Attribute)
                and isinstance(e.func.value, ast.Name)
                and e.func.value.id == "np"
                and e.func.attr in ("empty", "zeros")):
            return None
        if not e.args:
            return None
        shape = e.args[0]
        dims = shape.elts if isinstance(shape, ast.Tuple) else [shape]
        rendered = []
        for d in dims:
            from .enginesrc import _fold_expr
            v = _fold_expr(d, self.consts)
            rendered.append(_const_repr(v) if v is not None else "x")
        dtype = "i"
        if len(e.args) > 1 and isinstance(e.args[1], ast.Attribute):
            dtype = "f" if "float" in e.args[1].attr else "i"
        return "(" + ",".join(rendered) + "):" + dtype

    def _for(self, s: ast.For) -> str:
        if not (isinstance(s.iter, ast.Call)
                and isinstance(s.iter.func, ast.Name)
                and s.iter.func.id == "range"
                and isinstance(s.target, ast.Name)):
            raise TwinNormalizeError("non-range for loop", s.lineno)
        args = s.iter.args
        if len(args) == 1:
            lo: Optional[ast.expr] = None
            hi = args[0]
        elif len(args) == 2:
            lo, hi = args
        else:
            raise TwinNormalizeError("stepped range loop", s.lineno)
        lo_kind = "0" if lo is None else self._expr(lo)
        hi_kind = self._expr(hi)
        self.summary.loops[f"({lo_kind},{hi_kind})"] += 1
        return "L{" + self._block(s.body) + "}"

    def _return(self, s: ast.Return) -> str:
        if s.value is None:
            self.summary.returns["R0"] += 1
            return "R0"
        if isinstance(s.value, ast.Tuple):
            arity = len(s.value.elts)
            for e in s.value.elts:
                self._expr(e)
        else:
            arity = 1
            self._expr(s.value)
        self.summary.returns[f"R{arity}"] += 1
        return f"R{arity}"

    # -- expressions -> kinds
    def _expr(self, e: ast.expr, write: bool = False) -> str:
        if isinstance(e, ast.Constant):
            if isinstance(e.value, bool):
                return _const_repr(int(e.value))
            if isinstance(e.value, (int, float)):
                return _const_repr(e.value)
            raise TwinNormalizeError(
                f"unsupported constant {e.value!r}", e.lineno)
        if isinstance(e, ast.Name):
            if e.id in self.consts:
                return _const_repr(self.consts[e.id])
            return "x"
        if isinstance(e, ast.Attribute):
            if isinstance(e.value, ast.Name) and e.value.id == "math":
                if e.attr == "nan":
                    return "NAN"
                if e.attr == "inf":
                    return "INF"
            return "x"
        if isinstance(e, ast.Subscript):
            return self._arrayref(e, write)
        if isinstance(e, ast.BinOp):
            op = _PY_BINOPS.get(type(e.op))
            if op is None:
                raise TwinNormalizeError(
                    f"unsupported operator {type(e.op).__name__}", e.lineno)
            lk = self._expr(e.left)
            rk = self._expr(e.right)
            self.summary.binops[_bin_sig(op, lk, rk)] += 1
            return "x"
        if isinstance(e, ast.BoolOp):
            op = "and" if isinstance(e.op, ast.And) else "or"
            for v in e.values:
                self._expr(v)
            self.summary.binops[f"({op},{len(e.values)})"] += 1
            return "x"
        if isinstance(e, ast.UnaryOp):
            if isinstance(e.op, ast.USub):
                inner = self._expr(e.operand)
                if inner not in ("x",) and not inner.startswith("-"):
                    # Folded constant negation: -1, -INF ...
                    if inner == "INF":
                        return "-INF"
                    try:
                        return _const_repr(-float(inner)
                                           if "." in inner or "e" in inner
                                           else -int(inner))
                    except ValueError:
                        pass
                self.summary.binops[f"(neg,{inner})"] += 1
                return "x"
            if isinstance(e.op, ast.Not):
                self._expr(e.operand)
                self.summary.binops["(not)"] += 1
                return "x"
            raise TwinNormalizeError(
                f"unsupported unary op {type(e.op).__name__}", e.lineno)
        if isinstance(e, ast.Compare):
            if len(e.ops) != 1:
                raise TwinNormalizeError("chained comparison", e.lineno)
            op = _PY_CMPOPS.get(type(e.ops[0]))
            if op is None:
                raise TwinNormalizeError(
                    f"unsupported comparison {type(e.ops[0]).__name__}",
                    e.lineno)
            lk = self._expr(e.left)
            rk = self._expr(e.comparators[0])
            self.summary.compares[_cmp_sig(op, lk, rk)] += 1
            return "x"
        if isinstance(e, ast.IfExp):
            self._expr(e.test)
            a = self._expr(e.body)
            b = self._expr(e.orelse)
            self.summary.selects[f"({a},{b})"] += 1
            return "x"
        if isinstance(e, ast.Call):
            return self._call(e)
        raise TwinNormalizeError(
            f"unsupported expression {type(e).__name__}", e.lineno)

    def _call(self, e: ast.Call) -> str:
        func = e.func
        if isinstance(func, ast.Name):
            name = func.id
            if name == "int" and len(e.args) == 1:
                self._expr(e.args[0])   # cast: erased in the IR
                return "x"
            callee = name.lstrip("_") if name.startswith("_") else name
        elif (isinstance(func, ast.Attribute)
              and isinstance(func.value, ast.Name)
              and func.value.id == "math"):
            callee = func.attr
        else:
            raise TwinNormalizeError("unsupported call target", e.lineno)
        kinds = []
        for a in e.args:
            if isinstance(a, ast.Name) and (
                    a.id == self.state_param or a.id in self.aliases):
                continue    # state plumbing: dropped on both sides
            kinds.append(self._expr(a))
        self.summary.calls[f"{callee}({','.join(kinds)})"] += 1
        return "x"

    def _arrayref(self, e: ast.Subscript, write: bool) -> str:
        if not isinstance(e.value, ast.Name):
            raise TwinNormalizeError("nested subscript base", e.lineno)
        base = e.value.id
        if base == self.state_param:
            raise TwinNormalizeError(
                "raw state-tuple subscript outside prologue", e.lineno)
        if base in self.aliases:
            arr = self.aliases[base]
        elif base in self.local_arrays:
            arr = self.local_arrays[base]
        else:
            raise TwinNormalizeError(
                f"subscript of unknown array {base!r}", e.lineno)
        idx = e.slice
        dims = idx.elts if isinstance(idx, ast.Tuple) else [idx]
        rendered = [self._index(d) for d in dims]
        if arr in ("smf", "dcf") and len(rendered) == 1:
            rendered.append("0")
        sig = f"{arr}[{','.join(rendered)}]"
        if write:
            self.summary.writes[sig] += 1
        else:
            self.summary.reads.add(sig)
        return "x"

    def _index(self, e: ast.expr) -> str:
        """Symbolic index rendering (richer than kinds: keeps + shapes)."""
        if isinstance(e, ast.Constant) and isinstance(e.value, (int, float)):
            return _const_repr(e.value)
        if isinstance(e, ast.Name):
            if e.id in self.consts:
                return _const_repr(self.consts[e.id])
            return "x"
        if isinstance(e, ast.BinOp):
            op = _PY_BINOPS.get(type(e.op))
            if op is None:
                raise TwinNormalizeError("unsupported index op", e.lineno)
            # Index arithmetic lands in the read/write signature itself,
            # not in the binop bag (the C side mirrors this).
            return _bin_sig(op, self._index(e.left), self._index(e.right))
        if isinstance(e, ast.UnaryOp) and isinstance(e.op, ast.USub):
            inner = self._index(e.operand)
            if inner != "x":
                return "-" + inner
            return "x"
        if isinstance(e, ast.Call):
            self._call(e)
            return "x"
        if isinstance(e, ast.Subscript):
            self._arrayref(e, write=False)
            return "x"
        return "x"


# --------------------------------------------------------- C macro table
@dataclass
class MacroShape:
    """A flat-accessor macro, e.g. ``RI(r,c) -> S->ri[(r)*RI_LEN+(c)]``."""
    name: str
    array: str
    ndim: int
    strides: Tuple[object, ...]     # per-dim multiplier names/values
    uses_nsm: bool = False
    line: int = 0


def _macro_shape(macro: cparse.CMacro,
                 struct_names: Sequence[str]) -> Optional[MacroShape]:
    """Recognize a macro body as a flat array accessor; None otherwise."""
    try:
        sub = cparse._Parser(list(macro.body), {}, struct_names)
        e = sub.parse_expr()
        if sub._peek() is not None:
            return None
    except CParseError:
        return None
    if not (isinstance(e, tuple) and e[0] == "idx"):
        return None
    base, idx = e[1], e[2]
    if not (base[0] == "mem" and base[1] == ("name", "S")):
        return None
    array = base[2]
    params = macro.params or []

    def is_param(x, i):
        return x == ("name", params[i])

    # 1-dim: BODY = S->arr[(p0)]
    if len(params) == 1 and is_param(idx, 0):
        return MacroShape(macro.name, array, 1, (), False, macro.line)
    # 2-dim: S->arr[(p0) * STRIDE + (p1)]
    if (len(params) == 2 and idx[0] == "bin" and idx[1] == "+"
            and idx[2][0] == "bin" and idx[2][1] == "*"
            and is_param(idx[2][2], 0) and is_param(idx[3], 1)):
        stride = idx[2][3]
        if stride[0] in ("name", "num"):
            return MacroShape(macro.name, array, 2, (stride[1],), False,
                             macro.line)
    # 3-dim: S->arr[((p0) * S->nsm + (p1)) * K + (p2)]
    if (len(params) == 3 and idx[0] == "bin" and idx[1] == "+"
            and is_param(idx[3], 2)
            and idx[2][0] == "bin" and idx[2][1] == "*"):
        outer, k = idx[2][2], idx[2][3]
        if (k[0] in ("name", "num") and outer[0] == "bin"
                and outer[1] == "+" and is_param(outer[3], 1)
                and outer[2][0] == "bin" and outer[2][1] == "*"
                and is_param(outer[2][2], 0)
                and outer[2][3] == ("mem", ("name", "S"), "nsm")):
            return MacroShape(macro.name, array, 3, ("nsm", k[1]), True,
                             macro.line)
    return None


def macro_shapes(unit: CUnit) -> Tuple[Dict[str, MacroShape], List[str]]:
    """(name -> shape) for every accessor macro, plus unrecognized names."""
    shapes: Dict[str, MacroShape] = {}
    bad: List[str] = []
    for name, macro in unit.macros.items():
        shape = _macro_shape(macro, unit.structs.keys())
        if shape is None:
            bad.append(name)
        else:
            shapes[name] = shape
    return shapes, bad


# ---------------------------------------------------------- C normalizer
class CNormalizeError(Exception):
    def __init__(self, message: str, line: int = 0):
        super().__init__(message)
        self.line = line


#: C callee -> twin-canonical callee.
_C_CALLEE_MAP = {"fs_decide": "decide", "fs_advance": "advance"}

#: Ev struct fields — member reads of event variables are plain scalars.
_EV_RETURN_ARITY = 7


class _CNormalizer:
    """Lower one C function into the shared :class:`FuncSummary`."""

    def __init__(self, fn: CFunc, unit: CUnit,
                 shapes: Dict[str, MacroShape],
                 consts: Dict[str, object]):
        self.fn = fn
        self.unit = unit
        self.shapes = shapes
        self.consts = consts
        self.summary = FuncSummary(name=fn.name, line=fn.line)
        self.struct_vars: Dict[str, str] = {}   # var -> struct type
        self.local_arrays: Dict[str, str] = {}
        self.out_params: set = set()
        n = 0
        for ctype, is_ptr, name in fn.params:
            if ctype in unit.structs:
                self.struct_vars[name] = ctype
                continue
            if name in CANONICAL_ARRAYS:
                continue    # fs_advance raw-pointer interface
            if is_ptr:
                self.out_params.add(name)
                continue
            n += 1
        self.summary.params = n
        self.return_arity = 1 if fn.rtype != "void" else 0
        self.return_arity += len(self.out_params)

    def run(self) -> FuncSummary:
        self.summary.skeleton = self._block(self.fn.body)
        return self.summary

    # -- statements
    def _block(self, stmts: Sequence[object]) -> str:
        return "".join(self._stmt(s) for s in stmts)

    def _stmt(self, s) -> str:
        if isinstance(s, CDecl):
            return self._decl(s)
        if isinstance(s, CAssign):
            return self._assign(s)
        if isinstance(s, CExprStmt):
            self._expr(s.expr)
            return ""
        if isinstance(s, CIf):
            self._expr(s.cond)
            frag = "I{" + self._block(s.then) + "}"
            if s.orelse:
                frag += "E{" + self._block(s.orelse) + "}"
            return frag
        if isinstance(s, CWhile):
            if s.cond == ("num", 1):
                return "F{" + self._block(s.body) + "}"
            self._expr(s.cond)
            return "W{" + self._block(s.body) + "}"
        if isinstance(s, CFor):
            return self._for(s)
        if isinstance(s, CReturn):
            return self._return(s)
        if isinstance(s, CBreak):
            return "B"
        if isinstance(s, CContinue):
            return "C"
        raise CNormalizeError(f"unsupported statement {type(s).__name__}",
                              getattr(s, "line", 0))

    def _decl(self, s: CDecl) -> str:
        if s.ctype in self.unit.structs:
            if not s.is_pointer:
                self.struct_vars[s.name] = s.ctype
                if s.init is not None:
                    self._expr(s.init)
                return ""
            # ``St *S = &state;`` — alias plumbing, invisible.
            self.struct_vars[s.name] = s.ctype
            return ""
        if s.array_dims:
            dims = [self._fold_c(d) for d in s.array_dims]
            rendered = [_const_repr(v) if v is not None else "x"
                        for v in dims]
            dtype = "f" if s.ctype in ("double", "float") else "i"
            label = f"local{len(self.local_arrays)}"
            self.local_arrays[s.name] = label
            self.summary.local_arrays[
                f"{label}({','.join(rendered)}):{dtype}"] += 1
            return ""
        if s.init is not None:
            self._expr(s.init)      # scalar init: like an assignment
        return ""

    def _assign(self, s: CAssign) -> str:
        target = s.target
        if s.op == "=":
            if target[0] in ("name", "mem") or (
                    target[0] == "un" and target[1] == "*"):
                self._expr(s.value)     # scalar store: invisible
                return ""
            self._expr(target, write=True)
            self._expr(s.value)
            return ""
        op = s.op[0]    # "+=" -> "+"
        target_kind = self._expr(
            target, write=target[0] not in ("name", "mem"))
        value_kind = self._expr(s.value)
        if target[0] in ("name", "mem"):
            target_kind = "x"
        self.summary.binops[_bin_sig(op, target_kind, value_kind)] += 1
        return ""

    def _for(self, s: CFor) -> str:
        if s.init is None and s.cond is None and s.step is None:
            return "F{" + self._block(s.body) + "}"
        # Counted loop: for (v = lo; v < hi; v++)
        if (isinstance(s.init, CAssign) and s.init.op == "="
                and s.init.target[0] == "name"
                and isinstance(s.step, CAssign) and s.step.op == "+="
                and s.step.value == ("num", 1)
                and s.step.target == s.init.target
                and s.cond is not None and s.cond[0] == "cmp"
                and s.cond[1] == "<" and s.cond[2] == s.init.target):
            lo_kind = self._expr(s.init.value)
            hi_kind = self._expr(s.cond[3])
            self.summary.loops[f"({lo_kind},{hi_kind})"] += 1
            return "L{" + self._block(s.body) + "}"
        raise CNormalizeError("unrecognized for-loop shape",
                              getattr(s, "line", 0))

    def _return(self, s: CReturn) -> str:
        if s.value is None:
            arity = self.return_arity
            tag = f"R{arity}" if arity else "R0"
            self.summary.returns[tag] += 1
            return tag
        if (s.value[0] == "name"
                and self.struct_vars.get(s.value[1]) == "Ev"):
            arity = _EV_RETURN_ARITY
        else:
            arity = self.return_arity
            self._expr(s.value)
        self.summary.returns[f"R{arity}"] += 1
        return f"R{arity}"

    # -- expressions
    def _fold_c(self, e) -> Optional[object]:
        if e[0] == "num":
            return e[1]
        if e[0] == "name":
            name = e[1]
            twin_name = C_CONST_ALIASES.get(name, name)
            return self.consts.get(twin_name)
        if e[0] == "un" and e[1] == "-":
            v = self._fold_c(e[2])
            return None if v is None else -v
        if e[0] == "bin" and e[1] in ("+", "-", "*"):
            a, b = self._fold_c(e[2]), self._fold_c(e[3])
            if a is None or b is None:
                return None
            return a + b if e[1] == "+" else (
                a - b if e[1] == "-" else a * b)
        return None

    def _expr(self, e, write: bool = False) -> str:
        tag = e[0]
        if tag == "num":
            return _const_repr(e[1])
        if tag == "name":
            name = e[1]
            if name == "NAN":
                return "NAN"
            if name == "INFINITY":
                return "INF"
            twin_name = C_CONST_ALIASES.get(name, name)
            if twin_name in self.consts:
                return _const_repr(self.consts[twin_name])
            return "x"
        if tag == "mem":
            return "x"      # Ev fields, state.X, S->nsm: scalars
        if tag == "mcall":
            return self._macro_ref(e, write)
        if tag == "idx":
            return self._idx_ref(e, write)
        if tag == "cast":
            return self._expr(e[2])     # casts erased in the IR
        if tag == "un":
            op = e[1]
            if op == "-":
                v = self._fold_c(e)
                if v is not None:
                    return _const_repr(v)
                inner = self._expr(e[2])
                if inner == "INF":
                    return "-INF"
                self.summary.binops[f"(neg,{inner})"] += 1
                return "x"
            if op == "!":
                self._expr(e[2])
                self.summary.binops["(not)"] += 1
                return "x"
            if op == "&":
                return self._expr(e[2])     # &out_r address-of: transparent
            if op == "*":
                return self._expr(e[2])     # *out_r deref: transparent
            raise CNormalizeError(f"unsupported unary {op}")
        if tag == "bin":
            op = e[1]
            lk = self._expr(e[2])
            rk = self._expr(e[3])
            self.summary.binops[_bin_sig(op, lk, rk)] += 1
            return "x"
        if tag == "cmp":
            op = e[1]
            lk = self._expr(e[2])
            rk = self._expr(e[3])
            self.summary.compares[_cmp_sig(op, lk, rk)] += 1
            return "x"
        if tag == "bool":
            op = "and" if e[1] == "&&" else "or"
            for part in e[2]:
                self._expr(part)
            self.summary.binops[f"({op},{len(e[2])})"] += 1
            return "x"
        if tag == "tern":
            self._expr(e[1])
            a = self._expr(e[2])
            b = self._expr(e[3])
            self.summary.selects[f"({a},{b})"] += 1
            return "x"
        if tag == "call":
            return self._call(e)
        raise CNormalizeError(f"unsupported expression tag {tag}")

    def _call(self, e) -> str:
        name = e[1]
        callee = _C_CALLEE_MAP.get(name, name)
        kinds = []
        for a in e[2]:
            if a[0] == "name" and (a[1] in self.struct_vars
                                   or a[1] in CANONICAL_ARRAYS):
                continue    # state plumbing
            if a[0] == "un" and a[1] == "&":
                inner = a[2]
                if inner[0] == "name" and inner[1] not in CANONICAL_ARRAYS:
                    continue    # &out_r out-param: folded into return arity
                if inner[0] == "name":
                    continue
            kinds.append(self._expr(a))
        self.summary.calls[f"{callee}({','.join(kinds)})"] += 1
        return "x"

    def _macro_ref(self, e, write: bool) -> str:
        name, args = e[1], e[2]
        shape = self.shapes.get(name)
        if shape is None:
            raise CNormalizeError(f"unrecognized accessor macro {name}")
        rendered = [self._index(a) for a in args]
        if shape.array in ("smf", "dcf") and len(rendered) == 1:
            rendered.append("0")
        sig = f"{shape.array}[{','.join(rendered)}]"
        if write:
            self.summary.writes[sig] += 1
        else:
            self.summary.reads.add(sig)
        return "x"

    def _idx_ref(self, e, write: bool) -> str:
        # Flatten idx chains: batch[nb][0], S->act[i], bare param arr[i].
        dims = []
        base = e
        while base[0] == "idx":
            dims.append(base[2])
            base = base[1]
        dims.reverse()
        if base[0] == "mem" and base[1] == ("name", "S") \
                and base[2] in CANONICAL_ARRAYS:
            arr = base[2]
        elif base[0] == "name" and base[1] in CANONICAL_ARRAYS:
            arr = base[1]
        elif base[0] == "name" and base[1] in self.local_arrays:
            arr = self.local_arrays[base[1]]
        else:
            raise CNormalizeError(f"subscript of unknown base {base!r}")
        rendered = [self._index(d) for d in dims]
        sig = f"{arr}[{','.join(rendered)}]"
        if write:
            self.summary.writes[sig] += 1
        else:
            self.summary.reads.add(sig)
        return "x"

    def _index(self, e) -> str:
        tag = e[0]
        if tag == "num":
            return _const_repr(e[1])
        if tag == "name":
            twin_name = C_CONST_ALIASES.get(e[1], e[1])
            if twin_name in self.consts:
                return _const_repr(self.consts[twin_name])
            return "x"
        if tag == "bin":
            lk = self._index(e[2])
            rk = self._index(e[3])
            return _bin_sig(e[1], lk, rk)
        if tag == "un" and e[1] == "-":
            v = self._fold_c(e)
            if v is not None:
                return _const_repr(v)
            return "x"
        if tag == "cast":
            return self._index(e[2])
        if tag in ("mcall", "idx"):
            self._expr(e)
            return "x"
        if tag in ("call", "cmp", "tern", "bool", "mem"):
            self._expr(e)
            return "x"
        return "x"


# --------------------------------------------------------- C-side lints
def _walk_c_exprs(stmts):
    """Yield (expr, line) for every expression in a statement list."""
    for s in stmts:
        line = getattr(s, "line", 0)
        if isinstance(s, CDecl):
            if s.init is not None:
                yield s.init, line
            for d in s.array_dims:
                yield d, line
        elif isinstance(s, CAssign):
            yield s.target, line
            yield s.value, line
        elif isinstance(s, CExprStmt):
            yield s.expr, line
        elif isinstance(s, CIf):
            yield s.cond, line
            yield from _walk_c_exprs(s.then)
            yield from _walk_c_exprs(s.orelse)
        elif isinstance(s, CWhile):
            yield s.cond, line
            yield from _walk_c_exprs(s.body)
        elif isinstance(s, CFor):
            if s.init is not None:
                yield from _walk_c_exprs([s.init])
            if s.cond is not None:
                yield s.cond, line
            if s.step is not None:
                yield from _walk_c_exprs([s.step])
            yield from _walk_c_exprs(s.body)
        elif isinstance(s, CReturn):
            if s.value is not None:
                yield s.value, line


def _subexprs(e):
    yield e
    tag = e[0]
    if tag in ("num", "name"):
        return
    if tag == "mem":
        yield from _subexprs(e[1])
    elif tag == "un":
        yield from _subexprs(e[2])
    elif tag == "cast":
        yield from _subexprs(e[2])
    elif tag in ("bin", "cmp"):
        yield from _subexprs(e[2])
        yield from _subexprs(e[3])
    elif tag == "idx":
        yield from _subexprs(e[1])
        yield from _subexprs(e[2])
    elif tag == "tern":
        yield from _subexprs(e[1])
        yield from _subexprs(e[2])
        yield from _subexprs(e[3])
    elif tag == "bool":
        for p in e[2]:
            yield from _subexprs(p)
    elif tag in ("call", "mcall"):
        for a in e[2]:
            yield from _subexprs(a)


class _CTypeEnv:
    """Scalar floatness environment for one C function."""

    _FLOAT_FIELDS = {"t", "start"}      # Ev float members

    def __init__(self, fn: CFunc, unit: CUnit,
                 shapes: Dict[str, MacroShape],
                 consts: Dict[str, object]):
        self.consts = consts
        self.shapes = shapes
        self.var_types: Dict[str, str] = {}
        for ctype, is_ptr, name in fn.params:
            self.var_types[name] = ctype

        def collect(stmts):
            for s in stmts:
                if isinstance(s, CDecl):
                    self.var_types[s.name] = s.ctype
                elif isinstance(s, CIf):
                    collect(s.then)
                    collect(s.orelse)
                elif isinstance(s, (CWhile, CFor)):
                    collect(s.body)
        collect(fn.body)

    def is_float(self, e) -> bool:
        tag = e[0]
        if tag == "num":
            return isinstance(e[1], float)
        if tag == "name":
            name = e[1]
            if name in ("NAN", "INFINITY"):
                return True
            twin_name = C_CONST_ALIASES.get(name, name)
            if twin_name in self.consts:
                return isinstance(self.consts[twin_name], float)
            return self.var_types.get(name) in ("double", "float")
        if tag == "cast":
            return e[1] in ("double", "float")
        if tag == "un":
            if e[1] in ("-",):
                return self.is_float(e[2])
            return False
        if tag == "bin":
            return self.is_float(e[2]) or self.is_float(e[3])
        if tag == "tern":
            return self.is_float(e[2]) or self.is_float(e[3])
        if tag == "mem":
            return e[2] in self._FLOAT_FIELDS
        if tag == "mcall":
            shape = self.shapes.get(e[1])
            return bool(shape and ARRAY_DTYPES.get(shape.array) == "f")
        if tag == "idx":
            base = e
            while base[0] == "idx":
                base = base[1]
            if base[0] == "mem" and base[2] in ARRAY_DTYPES:
                return ARRAY_DTYPES[base[2]] == "f"
            if base[0] == "name":
                if base[1] in ARRAY_DTYPES:
                    return ARRAY_DTYPES[base[1]] == "f"
                return self.var_types.get(base[1]) in ("double", "float")
            return False
        if tag == "call":
            return e[1] in ("floor", "fabs", "fmin", "fmax")
        return False


def _lint_c_function(fn: CFunc, unit: CUnit,
                     shapes: Dict[str, MacroShape],
                     consts: Dict[str, object],
                     module: str) -> List[Finding]:
    findings: List[Finding] = []
    env = _CTypeEnv(fn, unit, shapes, consts)

    # narrowed-dtype: every scalar decl must be int64_t/double (plain
    # ``int`` tolerated only for 0/1 flags never used arithmetically).
    int_vars: Dict[str, int] = {}

    def scan_decls(stmts):
        for s in stmts:
            if isinstance(s, CDecl):
                if s.ctype in unit.structs or s.is_pointer:
                    continue
                if s.ctype in _WIDE_TYPES:
                    continue
                if s.ctype == _BOOL_OK_TYPE:
                    int_vars[s.name] = s.line
                    continue
                findings.append(Finding(
                    PASS, "narrowed-dtype", module, fn.name, s.line,
                    f"declaration '{s.ctype} {s.name}' narrows the engine's "
                    f"int64/float64 value domain"))
            elif isinstance(s, CIf):
                scan_decls(s.then)
                scan_decls(s.orelse)
            elif isinstance(s, (CWhile, CFor)):
                scan_decls(s.body)
    scan_decls(fn.body)
    for ctype, is_ptr, name in fn.params:
        if ctype in unit.structs or ctype in _WIDE_TYPES:
            continue
        findings.append(Finding(
            PASS, "narrowed-dtype", module, fn.name, fn.line,
            f"parameter '{ctype}{'*' if is_ptr else ''} {name}' narrows "
            f"the engine's int64/float64 value domain"))

    # ``int`` flags: flag arithmetic use or value-bearing assignment.
    if int_vars:
        def rhs_is_flaggy(e) -> bool:
            tag = e[0]
            if tag in ("num", "cmp", "bool"):
                return False
            if tag == "name":
                return e[1] not in int_vars and not (
                    C_CONST_ALIASES.get(e[1], e[1]) in consts)
            if tag == "un" and e[1] in ("-", "!"):
                return rhs_is_flaggy(e[2])
            if tag == "tern":
                return rhs_is_flaggy(e[2]) or rhs_is_flaggy(e[3])
            return True     # arithmetic, array reads, calls, casts ...

        def scan_stmts(stmts):
            for s in stmts:
                if isinstance(s, CAssign) and s.target[0] == "name" \
                        and s.target[1] in int_vars:
                    if s.op != "=" or rhs_is_flaggy(s.value):
                        findings.append(Finding(
                            PASS, "narrowed-dtype", module, fn.name, s.line,
                            f"'int {s.target[1]}' receives a non-flag "
                            f"value; widen to int64_t"))
                if isinstance(s, CIf):
                    scan_stmts(s.then)
                    scan_stmts(s.orelse)
                elif isinstance(s, (CWhile, CFor)):
                    scan_stmts(s.body)
        scan_stmts(fn.body)
        for e, line in _walk_c_exprs(fn.body):
            for sub in _subexprs(e):
                if sub[0] == "bin" and sub[1] in _ARITH_OPS:
                    for opnd in (sub[2], sub[3]):
                        if opnd[0] == "name" and opnd[1] in int_vars:
                            findings.append(Finding(
                                PASS, "narrowed-dtype", module, fn.name,
                                line,
                                f"'int {opnd[1]}' used in arithmetic; "
                                f"widen to int64_t"))

    # int-division: C ``/`` truncates toward zero, Python ``//`` floors;
    # any all-int division is a semantic trap on negative operands.
    for e, line in _walk_c_exprs(fn.body):
        for sub in _subexprs(e):
            if sub[0] == "bin" and sub[1] == "/":
                if not (env.is_float(sub[2]) or env.is_float(sub[3])):
                    findings.append(Finding(
                        PASS, "int-division", module, fn.name, line,
                        "all-integer '/' truncates in C but floors in "
                        "Python; cast an operand to double or restructure"))
            if sub[0] == "bin" and sub[1] == "%":
                if not (env.is_float(sub[2]) or env.is_float(sub[3])):
                    findings.append(Finding(
                        PASS, "int-division", module, fn.name, line,
                        "all-integer '%' differs from Python on negative "
                        "operands; restructure"))
    return findings


def _count_fma_shapes(unit: CUnit, shapes, consts) -> int:
    n = 0
    for fn in unit.functions:
        env = _CTypeEnv(fn, unit, shapes, consts)
        for e, _line in _walk_c_exprs(fn.body):
            for sub in _subexprs(e):
                if sub[0] == "bin" and sub[1] in ("+", "-"):
                    for opnd in (sub[2], sub[3]):
                        if (opnd[0] == "bin" and opnd[1] == "*"
                                and env.is_float(opnd)):
                            n += 1
                            break
    return n


def _build_flags(c_module: ast.Module) -> Tuple[set, int]:
    """String constants inside the compile ``subprocess.run`` argv."""
    flags: set = set()
    line = 0
    for node in ast.walk(c_module):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "run" and node.args):
            argv = node.args[0]
            if isinstance(argv, ast.List):
                line = node.lineno
                for el in argv.elts:
                    if isinstance(el, ast.Constant) and isinstance(
                            el.value, str):
                        flags.add(el.value)
    return flags, line


# ------------------------------------------------------------- the pass
def scan_translation(core_dir: Path) -> List[Finding]:
    core_dir = Path(core_dir)
    findings: List[Finding] = []

    if not twin_path(core_dir).exists() or not c_path(core_dir).exists():
        return findings     # nothing to validate in this tree

    twin_tree = load_twin_ast(core_dir)
    consts = fold_twin_constants(twin_tree)

    try:
        unit, c_module, body_line = parse_c_unit(core_dir)
    except CParseError as exc:
        return [Finding(PASS, "c-parse-error", _C_MODULE, "_C_BODY",
                        getattr(exc, "line", 0) or 0,
                        f"cannot parse _C_BODY: {exc}")]
    if unit is None:
        return [Finding(PASS, "c-parse-error", _C_MODULE, "_C_BODY", 0,
                        "_C_BODY string literal not found")]

    shapes, bad_macros = macro_shapes(unit)
    for name in sorted(bad_macros):
        macro = unit.macros[name]
        findings.append(Finding(
            PASS, "macro-shape", _C_MODULE, name, macro.line,
            f"accessor macro {name} does not match a recognized flat-"
            f"array pattern; the validator cannot check its uses"))

    # Constant drift: a hand-written object-like #define in _C_BODY either
    # shadows a generated twin constant (drift risk) or invents a C-only
    # constant the twin cannot see.  The clean translation has neither —
    # all numeric constants flow through the generated block.
    for macro in unit.object_defines:
        twin_name = C_CONST_ALIASES.get(macro.name, macro.name)
        value = _parse_define_value(macro)
        if twin_name in consts:
            twin_value = consts[twin_name]
            if value is None or not _values_equal(value, twin_value):
                findings.append(Finding(
                    PASS, "constant-drift", _C_MODULE, macro.name,
                    macro.line,
                    f"#define {macro.name} {_fmt(value)} shadows the twin "
                    f"constant {twin_name} = {_fmt(twin_value)}"))
            else:
                findings.append(Finding(
                    PASS, "constant-drift", _C_MODULE, macro.name,
                    macro.line,
                    f"#define {macro.name} duplicates the generated "
                    f"constants block; delete it"))
        else:
            findings.append(Finding(
                PASS, "constant-drift", _C_MODULE, macro.name, macro.line,
                f"#define {macro.name} has no twin counterpart; numeric "
                f"constants must live in fastsim_twin"))

    # Function pairing.
    twin_fns = twin_jit_functions(twin_tree)
    c_fns = {fn.name: fn for fn in unit.functions}
    paired: set = set()
    for twin_fn in twin_fns:
        cname = pair_name(twin_fn.name)
        c_fn = c_fns.get(cname)
        if c_fn is None:
            findings.append(Finding(
                PASS, "missing-function", _C_MODULE, cname, body_line,
                f"twin function {twin_fn.name} has no C counterpart "
                f"{cname}"))
            continue
        paired.add(cname)
        try:
            twin_sum = _TwinNormalizer(twin_fn, consts).run()
        except TwinNormalizeError as exc:
            findings.append(Finding(
                PASS, "twin-normalize", _TWIN_MODULE, twin_fn.name,
                exc.line or twin_fn.lineno, str(exc)))
            continue
        try:
            c_sum = _CNormalizer(c_fn, unit, shapes, consts).run()
        except CNormalizeError as exc:
            findings.append(Finding(
                PASS, "c-normalize", _C_MODULE, cname,
                exc.line or c_fn.line, str(exc)))
            continue
        for desc in twin_sum.diff(c_sum):
            findings.append(Finding(
                PASS, "pair-mismatch", _TWIN_MODULE, twin_fn.name,
                twin_fn.lineno,
                f"{twin_fn.name} vs C {cname}: {desc}"))
    for cname in sorted(set(c_fns) - paired):
        findings.append(Finding(
            PASS, "extra-function", _C_MODULE, cname, c_fns[cname].line,
            f"C function {cname} has no @_jit twin counterpart"))

    # C-side numeric lints.
    for fn in unit.functions:
        findings.extend(_lint_c_function(fn, unit, shapes, consts,
                                         _C_MODULE))

    # FMA contraction: the build line must pin -ffp-contract=off while
    # FMA-able float shapes exist (and -ffast-math is never acceptable).
    flags, flags_line = _build_flags(c_module)
    if "-ffast-math" in flags:
        findings.append(Finding(
            PASS, "fma-contract", _C_MODULE, "build", flags_line,
            "-ffast-math breaks IEEE semantics and bit-identity with the "
            "twin; remove it"))
    if "-ffp-contract=off" not in flags:
        n = _count_fma_shapes(unit, shapes, consts)
        if n:
            findings.append(Finding(
                PASS, "fma-contract", _C_MODULE, "build", flags_line,
                f"build line lacks -ffp-contract=off while _C_BODY has "
                f"{n} FMA-able float a*b+c shape(s); contraction would "
                f"break bit-identity with the twin"))
    return findings


def _parse_define_value(macro: cparse.CMacro) -> Optional[object]:
    try:
        sub = cparse._Parser(list(macro.body), {}, ())
        e = sub.parse_expr()
        if sub._peek() is not None:
            return None
    except CParseError:
        return None
    if e[0] == "num":
        return e[1]
    if e[0] == "un" and e[1] == "-" and e[2][0] == "num":
        return -e[2][1]
    return None


def _values_equal(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float):
        if math.isnan(a) and math.isnan(b):
            return True
    return type(a) is type(b) and a == b or (
        isinstance(a, (int, float)) and isinstance(b, (int, float))
        and float(a) == float(b))


def _fmt(v) -> str:
    return "?" if v is None else repr(v)
