"""Flat-layout / bounds cross-check across the engine trio.

The twin's ``*_LEN`` field tables are THE layout contract: ``fastsim``
allocates arrays from them, the twin indexes with the ``<FAM>_<FIELD>``
constants, and the C accessor macros hard-code the same strides.  A
drifted width, a column constant from the wrong family, or a record
buffer whose growth exit was dropped all corrupt state silently — the
runtime equivalence matrix only catches them when a sampled cell
happens to trip the bad index.  This pass checks the contract shape by
shape:

* ``family-gap`` — each ``<FAM>_*`` constant family with a ``_LEN``
  must enumerate distinct in-range column indices (full 0..LEN-1
  coverage except the documented SMI free-slot tail, which must satisfy
  ``SMI_LEN == SMI_FS0 + MAX_BLOCK_SLOTS``).
* ``state-order`` — the ``S_*`` position constants, the 29-tuple built
  by ``fastsim._build_state``, and the C ``St`` struct must all list
  the arrays in canonical order with the right element dtypes, and the
  ctypes interface must pass exactly that many pointers.
* ``alloc-width`` / ``stride-mismatch`` — the trailing dimension of
  every ``_build_state`` allocation must match the twin's ``_LEN`` and
  the stride baked into the corresponding C accessor macro.
* ``col-bounds`` / ``wrong-family`` — every constant column index in
  the twin must fold below its array's width and come from that array's
  own field family.
* ``missing-growth-exit`` / ``cap-unassigned`` — every ``CI_*_CAP``
  capacity must be guarded in ``advance`` by a headroom check returning
  a distinct exit code, and assigned a value by ``fastsim``; a growable
  buffer without a wired exit would overflow instead of re-entering.
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from .cparse import CParseError
from .enginesrc import (ARRAY_DTYPES, CANONICAL_ARRAYS, _fold_expr, c_path,
                        fold_twin_constants, load_module_ast, load_twin_ast,
                        sim_path, twin_jit_functions, twin_path)
from .report import Finding
from .translate import macro_shapes

PASS = "layout"

_TWIN = "fastsim_twin"
_SIM = "fastsim"
_C = "fastsim_c"

#: Families whose members must cover 0..LEN-1 exactly.
_FULL_FAMILIES = ("SI", "SD", "CI", "CF", "RI", "RF", "PI", "PF",
                  "HI", "HF", "S")

#: Column family expected per state array (None: variable columns only).
_COL_FAMILY: Dict[str, Optional[str]] = {
    "si": "SI", "sd": "SD", "ci": "CI", "cf": "CF", "ri": "RI",
    "rf": "RF", "psi": "PI", "psf": "PF", "smi": "SMI", "hi": "HI",
    "hf": "HF", "rwf": "RW", "srci": "SRC",
}

#: ``S_*`` abbreviation per canonical array.
_S_ABBREV = {"np_pool": "NP", "bt_pool": "BT"}

#: capacity constant -> counter guarding it in ``advance``.
_CAP_COUNTERS = {
    "CI_HEAP_CAP": "SI_HEAP_LEN",
    "CI_TRACE_CAP": "SI_TRACE_N",
    "CI_DEC_CAP": "SI_DEC_N",
    "CI_PRED_CAP": "SI_PRED_N",
}


def _family_members(consts: Dict[str, object],
                    prefix: str) -> Dict[str, int]:
    out = {}
    for name, value in consts.items():
        if name.startswith(prefix + "_") and isinstance(value, int) \
                and not isinstance(value, bool) and name != prefix + "_LEN":
            out[name] = value
    return out


def _check_families(consts: Dict[str, object]) -> List[Finding]:
    findings: List[Finding] = []

    def flag(context: str, message: str) -> None:
        findings.append(Finding(PASS, "family-gap", _TWIN, context, 0,
                                message))

    for fam in _FULL_FAMILIES:
        length = consts.get(fam + "_LEN")
        if not isinstance(length, int):
            flag(fam, f"{fam}_LEN is missing or non-integer")
            continue
        members = _family_members(consts, fam)
        values = sorted(members.values())
        if values != list(range(length)):
            dupes = {v for v in values if values.count(v) > 1}
            missing = sorted(set(range(length)) - set(values))
            extra = sorted(v for v in values if not 0 <= v < length)
            parts = []
            if dupes:
                parts.append(f"duplicate indices {sorted(dupes)}")
            if missing:
                parts.append(f"unused indices {missing}")
            if extra:
                parts.append(f"out-of-range indices {extra}")
            flag(fam, f"{fam}_* must cover 0..{length - 1} exactly: "
                      + "; ".join(parts))
    smi_len = consts.get("SMI_LEN")
    smi_fs0 = consts.get("SMI_FS0")
    slots = consts.get("MAX_BLOCK_SLOTS")
    if not (isinstance(smi_len, int) and isinstance(smi_fs0, int)
            and isinstance(slots, int)
            and smi_len == smi_fs0 + slots):
        flag("SMI", "SMI_LEN must equal SMI_FS0 + MAX_BLOCK_SLOTS "
                    "(free-slot stack tail)")
    for name, value in _family_members(consts, "SMI").items():
        if isinstance(smi_len, int) and not 0 <= value < smi_len:
            flag("SMI", f"{name} = {value} outside [0, SMI_LEN)")
    return findings


def _check_s_constants(consts: Dict[str, object]) -> List[Finding]:
    findings: List[Finding] = []
    for i, arr in enumerate(CANONICAL_ARRAYS):
        name = "S_" + _S_ABBREV.get(arr, arr.upper())
        if consts.get(name) != i:
            findings.append(Finding(
                PASS, "state-order", _TWIN, name, 0,
                f"{name} must be {i} (position of {arr!r} in the state "
                f"tuple), found {consts.get(name)!r}"))
    if consts.get("S_LEN") != len(CANONICAL_ARRAYS):
        findings.append(Finding(
            PASS, "state-order", _TWIN, "S_LEN", 0,
            f"S_LEN must be {len(CANONICAL_ARRAYS)}, found "
            f"{consts.get('S_LEN')!r}"))
    return findings


# ------------------------------------------------------ fastsim.py side
class _AllocSpec:
    """Trailing width + dtype of one ``_build_state`` allocation."""

    def __init__(self, width: Optional[int], dtype: Optional[str],
                 line: int):
        self.width = width      # None for 1-D arrays
        self.dtype = dtype      # "i" / "f" / None (unknown)
        self.line = line


def _np_attr(e: ast.expr) -> Optional[str]:
    if isinstance(e, ast.Attribute) and isinstance(e.value, ast.Name) \
            and e.value.id == "np":
        return e.attr
    return None


def _fold_sim_expr(e: ast.expr, consts: Dict[str, object]):
    """Fold ``tw.<CONST>``-style expressions in fastsim.py."""
    if isinstance(e, ast.Attribute) and isinstance(e.value, ast.Name) \
            and e.value.id == "tw":
        return consts.get(e.attr)
    if isinstance(e, ast.Constant) and isinstance(e.value, int) \
            and not isinstance(e.value, bool):
        return e.value
    return None


def _alloc_spec(call: ast.Call,
                consts: Dict[str, object]) -> Optional[_AllocSpec]:
    fn = _np_attr(call.func)
    if fn not in ("zeros", "empty", "full") or not call.args:
        return None
    shape = call.args[0]
    dtype_arg = call.args[-1] if len(call.args) >= 2 else None
    dtype = None
    attr = _np_attr(dtype_arg) if dtype_arg is not None else None
    if attr == "int64":
        dtype = "i"
    elif attr == "float64":
        dtype = "f"
    if isinstance(shape, ast.Tuple) and shape.elts:
        width = _fold_sim_expr(shape.elts[-1], consts)
        return _AllocSpec(width if isinstance(width, int) else None,
                          dtype, call.lineno)
    return _AllocSpec(None, dtype, call.lineno)


def _build_state_specs(sim_tree: ast.Module, consts: Dict[str, object],
                       findings: List[Finding],
                       ) -> Dict[str, _AllocSpec]:
    """canonical array -> allocation spec, via the 29-tuple's positions."""
    build = None
    for node in ast.walk(sim_tree):
        if isinstance(node, ast.FunctionDef) and node.name == "_build_state":
            build = node
            break
    if build is None:
        findings.append(Finding(
            PASS, "state-order", _SIM, "_build_state", 0,
            "fastsim._build_state not found; cannot cross-check the "
            "allocation layout"))
        return {}
    allocs: Dict[str, _AllocSpec] = {}
    state_tuple: Optional[ast.Tuple] = None
    for node in ast.walk(build):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            name = node.targets[0].id
            if isinstance(node.value, ast.Call):
                spec = _alloc_spec(node.value, consts)
                if spec is not None:
                    allocs[name] = spec
            if name == "state" and isinstance(node.value, ast.Tuple):
                state_tuple = node.value
    if state_tuple is None:
        findings.append(Finding(
            PASS, "state-order", _SIM, "_build_state", build.lineno,
            "state tuple literal not found in _build_state"))
        return {}
    if len(state_tuple.elts) != len(CANONICAL_ARRAYS):
        findings.append(Finding(
            PASS, "state-order", _SIM, "_build_state", state_tuple.lineno,
            f"state tuple has {len(state_tuple.elts)} element(s); the "
            f"engine contract is {len(CANONICAL_ARRAYS)}"))
        return {}
    specs: Dict[str, _AllocSpec] = {}
    for i, el in enumerate(state_tuple.elts):
        if not isinstance(el, ast.Name):
            findings.append(Finding(
                PASS, "state-order", _SIM, "_build_state", el.lineno,
                f"state tuple position {i} is not a plain local name"))
            continue
        spec = allocs.get(el.id)
        if spec is not None:
            specs[CANONICAL_ARRAYS[i]] = spec
    return specs


def _expected_width(arr: str, consts: Dict[str, object],
                    specs: Dict[str, _AllocSpec]) -> Optional[int]:
    spec = specs.get(arr)
    return spec.width if spec is not None else None


def _check_alloc_dtypes(specs: Dict[str, _AllocSpec]) -> List[Finding]:
    findings = []
    for arr, spec in specs.items():
        want = ARRAY_DTYPES[arr]
        if spec.dtype is not None and spec.dtype != want:
            label = "float64" if want == "f" else "int64"
            findings.append(Finding(
                PASS, "alloc-width", _SIM, "_build_state", spec.line,
                f"{arr} allocated with the wrong dtype; the engine "
                f"contract is {label}"))
    return findings


def _check_alloc_widths(specs: Dict[str, _AllocSpec],
                        consts: Dict[str, object]) -> List[Finding]:
    findings = []
    expected = {
        "ri": "RI_LEN", "rf": "RF_LEN", "psi": "PI_LEN", "psf": "PF_LEN",
        "bs": "MAX_BLOCK_SLOTS", "sl": "MAX_BLOCK_SLOTS",
        "smi": "SMI_LEN", "hi": "HI_LEN", "hf": "HF_LEN",
    }
    for arr, const in expected.items():
        spec = specs.get(arr)
        want = consts.get(const)
        if spec is None or not isinstance(want, int):
            continue
        if spec.width != want:
            findings.append(Finding(
                PASS, "alloc-width", _SIM, "_build_state", spec.line,
                f"{arr} trailing dimension {spec.width} != {const} "
                f"({want})"))
    return findings


# -------------------------------------------------------- twin subscripts
def _check_twin_columns(twin_tree: ast.Module, consts: Dict[str, object],
                        specs: Dict[str, _AllocSpec]) -> List[Finding]:
    findings: List[Finding] = []
    for fn in twin_jit_functions(twin_tree):
        aliases: Dict[str, str] = {}
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and isinstance(node.value, ast.Subscript) \
                    and isinstance(node.value.value, ast.Name) \
                    and node.value.value.id == "S" \
                    and isinstance(node.value.slice, ast.Constant) \
                    and isinstance(node.value.slice.value, int):
                idx = node.value.slice.value
                if 0 <= idx < len(CANONICAL_ARRAYS):
                    aliases[node.targets[0].id] = CANONICAL_ARRAYS[idx]
        for p in fn.args.args:
            if p.arg in CANONICAL_ARRAYS:
                aliases[p.arg] = p.arg
        for node in ast.walk(fn):
            if not isinstance(node, ast.Subscript):
                continue
            if not isinstance(node.value, ast.Name):
                continue
            arr = aliases.get(node.value.id)
            if arr is None:
                continue
            idx = node.slice
            dims = idx.elts if isinstance(idx, ast.Tuple) else [idx]
            col = dims[-1]
            width = _expected_width(arr, consts, specs)
            family = _COL_FAMILY.get(arr)
            if family is not None and isinstance(col, ast.Name) \
                    and col.id in consts:
                col_fam = col.id.split("_", 1)[0]
                if col_fam != family:
                    findings.append(Finding(
                        PASS, "wrong-family", _TWIN, fn.name, node.lineno,
                        f"{arr}[..] indexed with {col.id} from the "
                        f"{col_fam}_* family; {arr} columns are "
                        f"{family}_*"))
            value = _fold_expr(col, consts) if not isinstance(
                col, ast.Name) else consts.get(col.id)
            if width is not None and isinstance(value, int) \
                    and not isinstance(value, bool) and len(dims) > 1:
                if not -0 <= value < width:
                    findings.append(Finding(
                        PASS, "col-bounds", _TWIN, fn.name, node.lineno,
                        f"{arr}[.., {value}] exceeds the allocated "
                        f"width {width}"))
    return findings


# ----------------------------------------------------------- C-side shape
def _check_c_layout(core_dir: Path, consts: Dict[str, object],
                    specs: Dict[str, _AllocSpec]) -> List[Finding]:
    findings: List[Finding] = []
    from .enginesrc import parse_c_unit
    try:
        unit, c_module, _line = parse_c_unit(core_dir)
    except CParseError:
        return []       # translate reports the parse failure
    if unit is None:
        return []

    # St struct: canonical order, per-array pointer dtypes, nsm tail.
    st = unit.structs.get("St")
    if st is None:
        findings.append(Finding(
            PASS, "state-order", _C, "St", 0,
            "St struct not found in _C_BODY"))
    else:
        want_fields = [
            ("double *" if ARRAY_DTYPES[a] == "f" else "int64_t *", a)
            for a in CANONICAL_ARRAYS] + [("int64_t", "nsm")]
        got_fields = [(f"{ctype} *" if is_ptr else ctype, name)
                      for ctype, is_ptr, name in st.fields]
        if got_fields != want_fields:
            for i, (want, got) in enumerate(zip(want_fields, got_fields)):
                if want != got:
                    findings.append(Finding(
                        PASS, "state-order", _C, "St", st.line,
                        f"St field {i} is {got[0]} {got[1]!r}; the state "
                        f"contract requires {want[0]} {want[1]!r}"))
            if len(got_fields) != len(want_fields):
                findings.append(Finding(
                    PASS, "state-order", _C, "St", st.line,
                    f"St has {len(got_fields)} fields; the state "
                    f"contract requires {len(want_fields)}"))
    ev = unit.structs.get("Ev")
    ev_want = [("double", "t"), ("int64_t", "kind"), ("int64_t", "seq"),
               ("int64_t", "a"), ("int64_t", "b"), ("int64_t", "c"),
               ("double", "start")]
    if ev is not None:
        got = [(ctype, name) for ctype, _p, name in ev.fields]
        if got != ev_want:
            findings.append(Finding(
                PASS, "state-order", _C, "Ev", ev.line,
                f"Ev fields {got} diverge from the heap row contract "
                f"{ev_want}"))

    # Accessor macro strides vs the fastsim allocation widths.
    shapes, _bad = macro_shapes(unit)
    for name, shape in sorted(shapes.items()):
        width = _expected_width(shape.array, consts, specs)
        if width is None:
            if shape.ndim != 1:
                continue
            spec = specs.get(shape.array)
            if spec is not None and spec.width not in (None, 1):
                findings.append(Finding(
                    PASS, "stride-mismatch", _C, name, shape.line,
                    f"{name} indexes {shape.array} as 1-D but the "
                    f"allocation is {spec.width} wide"))
            continue
        if shape.ndim == 1:
            if width != 1:
                findings.append(Finding(
                    PASS, "stride-mismatch", _C, name, shape.line,
                    f"{name} indexes {shape.array} as 1-D but the "
                    f"allocation is {width} wide"))
            continue
        stride = shape.strides[-1]
        stride_v = stride if isinstance(stride, int) else consts.get(
            str(stride))
        if stride_v != width:
            findings.append(Finding(
                PASS, "stride-mismatch", _C, name, shape.line,
                f"{name} stride {stride!r} ({stride_v}) != {shape.array} "
                f"allocation width {width}"))
        if shape.ndim == 3 and not shape.uses_nsm:
            findings.append(Finding(
                PASS, "stride-mismatch", _C, name, shape.line,
                f"{name} middle stride must be S->nsm"))

    # ctypes interface: exactly one pointer per state array.
    n_args = None
    for node in ast.walk(c_module):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Attribute) \
                and node.targets[0].attr == "argtypes" \
                and isinstance(node.value, ast.BinOp) \
                and isinstance(node.value.op, ast.Mult) \
                and isinstance(node.value.right, ast.Constant):
            n_args = (node.value.right.value, node.lineno)
    if n_args is not None and n_args[0] != len(CANONICAL_ARRAYS):
        findings.append(Finding(
            PASS, "state-order", _C, "argtypes", n_args[1],
            f"fs_advance takes {n_args[0]} pointers; the state contract "
            f"is {len(CANONICAL_ARRAYS)}"))
    return findings


# -------------------------------------------------- buffer-growth wiring
def _check_growth_exits(twin_tree: ast.Module, sim_tree: ast.Module,
                        consts: Dict[str, object]) -> List[Finding]:
    findings: List[Finding] = []
    caps = sorted(n for n in consts
                  if n.startswith("CI_") and n.endswith("_CAP")
                  and n in _CAP_COUNTERS)
    for cap in sorted(set(_CAP_COUNTERS) - set(caps)):
        findings.append(Finding(
            PASS, "missing-growth-exit", _TWIN, "advance", 0,
            f"growable-buffer capacity constant {cap} is missing"))

    advance = None
    for fn in twin_jit_functions(twin_tree):
        if fn.name == "advance":
            advance = fn
            break
    guarded: Dict[str, Tuple[int, int]] = {}
    if advance is None:
        findings.append(Finding(
            PASS, "missing-growth-exit", _TWIN, "advance", 0,
            "twin advance() not found"))
    else:
        for node in ast.walk(advance):
            if not (isinstance(node, ast.If) and len(node.body) == 1
                    and isinstance(node.body[0], ast.Return)
                    and isinstance(node.body[0].value, ast.Constant)
                    and isinstance(node.body[0].value.value, int)):
                continue
            code = node.body[0].value.value
            for sub in ast.walk(node.test):
                if isinstance(sub, ast.Subscript) \
                        and isinstance(sub.value, ast.Name) \
                        and isinstance(sub.slice, ast.Name) \
                        and sub.slice.id in _CAP_COUNTERS:
                    guarded[sub.slice.id] = (code, node.lineno)
        for cap in caps:
            if cap not in guarded:
                findings.append(Finding(
                    PASS, "missing-growth-exit", _TWIN, "advance",
                    advance.lineno,
                    f"advance() has no headroom guard on {cap}; the "
                    f"buffer would overflow instead of exiting for a "
                    f"rebuild"))
            else:
                code, line = guarded[cap]
                counter = _CAP_COUNTERS[cap]
                test_ok = False
                for node in ast.walk(advance):
                    if isinstance(node, ast.If) and node.lineno == line:
                        for sub in ast.walk(node.test):
                            if isinstance(sub, ast.Subscript) \
                                    and isinstance(sub.slice, ast.Name) \
                                    and sub.slice.id == counter:
                                test_ok = True
                if not test_ok:
                    findings.append(Finding(
                        PASS, "missing-growth-exit", _TWIN, "advance",
                        line,
                        f"the {cap} guard does not test the {counter} "
                        f"counter"))
        codes = [c for c, _l in guarded.values()]
        if len(set(codes)) != len(codes):
            findings.append(Finding(
                PASS, "missing-growth-exit", _TWIN, "advance",
                advance.lineno if advance else 0,
                f"growth-exit codes {sorted(codes)} are not distinct"))

    # fastsim must assign every capacity before entering the engine.
    assigned = set()
    for node in ast.walk(sim_tree):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Subscript) \
                        and isinstance(t.slice, ast.Attribute) \
                        and isinstance(t.slice.value, ast.Name) \
                        and t.slice.value.id == "tw":
                    assigned.add(t.slice.attr)
    for cap in caps:
        if cap not in assigned:
            findings.append(Finding(
                PASS, "cap-unassigned", _SIM, "_build_state", 0,
                f"fastsim never assigns ci[tw.{cap}]; the engine would "
                f"see a zero capacity and exit-loop forever"))
    return findings


# ------------------------------------------------------------- the pass
def scan_layout(core_dir: Path) -> List[Finding]:
    core_dir = Path(core_dir)
    if not twin_path(core_dir).exists():
        return []
    twin_tree = load_twin_ast(core_dir)
    consts = fold_twin_constants(twin_tree)

    findings: List[Finding] = []
    findings.extend(_check_families(consts))
    findings.extend(_check_s_constants(consts))

    specs: Dict[str, _AllocSpec] = {}
    sim_tree: Optional[ast.Module] = None
    if sim_path(core_dir).exists():
        sim_tree = load_module_ast(sim_path(core_dir))
        specs = _build_state_specs(sim_tree, consts, findings)
        findings.extend(_check_alloc_dtypes(specs))
        findings.extend(_check_alloc_widths(specs, consts))
    findings.extend(_check_twin_columns(twin_tree, consts, specs))
    if c_path(core_dir).exists():
        findings.extend(_check_c_layout(core_dir, consts, specs))
    if sim_tree is not None:
        findings.extend(_check_growth_exits(twin_tree, sim_tree, consts))
    return findings
