"""Shared AST-level access to the three engine sources.

The engine-verification passes (:mod:`repro_torch.analysis.conformance`,
:mod:`repro_torch.analysis.translate`, :mod:`repro_torch.analysis.layout`) all need
the same raw material: the twin's module AST and folded layout
constants, and the C backend's ``_C_BODY`` parsed through
:mod:`repro_torch.analysis.cparse`.  Everything here is file-level — the
analyzer never imports ``repro_torch.core`` — so the passes run unchanged
against ``--core-dir`` scratch trees.
"""

from __future__ import annotations

import ast
import math
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from .cparse import CUnit, parse_c

#: State-tuple array names in S-order — THE cross-backend contract
#: (twin ``S_*`` constants, ``fastsim._build_state`` tuple, C ``St``
#: struct fields, ``fs_advance`` parameters all follow this order).
CANONICAL_ARRAYS: Tuple[str, ...] = (
    "si", "sd", "ci", "cf", "ri", "rf", "psi", "psf", "bs", "sl",
    "smi", "smf", "hi", "hf", "tri", "trf", "dci", "dcf", "pri", "prf",
    "act", "q", "rwi", "rwf", "newc", "cand", "crem",
    "np_pool", "bt_pool", "srci", "srcf",
)

#: dtype kind per state array: "i" = int64, "f" = float64.
ARRAY_DTYPES: Dict[str, str] = {
    "si": "i", "sd": "f", "ci": "i", "cf": "f", "ri": "i", "rf": "f",
    "psi": "i", "psf": "f", "bs": "f", "sl": "i", "smi": "i", "smf": "f",
    "hi": "i", "hf": "f", "tri": "i", "trf": "f", "dci": "i", "dcf": "f",
    "pri": "i", "prf": "f", "act": "i", "q": "i", "rwi": "i", "rwf": "f",
    "newc": "i", "cand": "i", "crem": "f", "np_pool": "f", "bt_pool": "f",
    "srci": "i", "srcf": "f",
}

#: twin function -> C function where stripping the underscore isn't it.
PAIR_OVERRIDES: Dict[str, str] = {
    "_decide": "fs_decide",
    "advance": "fs_advance",
}

#: Float-constant names the generated ``#define`` block maps specially.
C_CONST_ALIASES: Dict[str, str] = {
    "FS_EPS": "_EPS",
    "NAN": "_NAN",
    "INFINITY": "_INF",
}


def twin_path(core_dir: Path) -> Path:
    return Path(core_dir) / "fastsim_twin.py"


def c_path(core_dir: Path) -> Path:
    return Path(core_dir) / "fastsim_c.py"


def sim_path(core_dir: Path) -> Path:
    return Path(core_dir) / "fastsim.py"


def load_twin_ast(core_dir: Path) -> ast.Module:
    path = twin_path(core_dir)
    return ast.parse(path.read_text(), filename=str(path))


def load_module_ast(path: Path) -> ast.Module:
    return ast.parse(path.read_text(), filename=str(path))


def extract_c_body(c_module: ast.Module) -> Tuple[Optional[str], int]:
    """The ``_C_BODY`` string literal and its line number."""
    for node in c_module.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == "_C_BODY"
                and isinstance(node.value, ast.Constant)
                and isinstance(node.value.value, str)):
            return node.value.value, node.lineno
    return None, 0


def parse_c_unit(core_dir: Path) -> Tuple[Optional[CUnit], ast.Module, int]:
    """(parsed C body or None, fastsim_c module AST, _C_BODY line)."""
    module = load_module_ast(c_path(core_dir))
    body, line = extract_c_body(module)
    if body is None:
        return None, module, 0
    return parse_c(body), module, line


# ------------------------------------------------------- constant folding
def _fold_expr(node: ast.expr, consts: Dict[str, object]):
    """Fold a module-level constant expression; None when unfoldable."""
    if isinstance(node, ast.Constant):
        if isinstance(node.value, bool):
            return None
        if isinstance(node.value, (int, float)):
            return node.value
        return None
    if isinstance(node, ast.Name):
        return consts.get(node.id)
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        inner = _fold_expr(node.operand, consts)
        return None if inner is None else -inner
    if isinstance(node, ast.BinOp):
        left = _fold_expr(node.left, consts)
        right = _fold_expr(node.right, consts)
        if left is None or right is None:
            return None
        if isinstance(node.op, ast.Add):
            return left + right
        if isinstance(node.op, ast.Sub):
            return left - right
        if isinstance(node.op, ast.Mult):
            return left * right
        if isinstance(node.op, ast.Div):
            return left / right
        return None
    if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
            and node.func.id == "float" and len(node.args) == 1
            and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, str)):
        try:
            return float(node.args[0].value)
        except ValueError:
            return None
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name):
        if node.value.id == "math" and node.attr in ("nan", "inf", "pi"):
            return getattr(math, node.attr)
    return None


def fold_twin_constants(tree: ast.Module) -> Dict[str, object]:
    """Module-level numeric constants (the generated-#define universe).

    Covers plain ``NAME = <literal/expr>`` and tuple assignments like the
    ``S_*`` block; bools are excluded exactly as ``_c_defines`` excludes
    them.
    """
    consts: Dict[str, object] = {}
    for node in tree.body:
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        target = node.targets[0]
        if isinstance(target, ast.Name):
            value = _fold_expr(node.value, consts)
            if value is not None:
                consts[target.id] = value
        elif (isinstance(target, ast.Tuple)
              and isinstance(node.value, ast.Tuple)
              and len(target.elts) == len(node.value.elts)
              and all(isinstance(e, ast.Name) for e in target.elts)):
            for name_node, val_node in zip(target.elts, node.value.elts):
                value = _fold_expr(val_node, consts)
                if value is not None:
                    consts[name_node.id] = value
    return consts


def twin_jit_functions(tree: ast.Module) -> List[ast.FunctionDef]:
    """Module-level functions decorated ``@_jit`` (the engine kernel)."""
    out = []
    for node in tree.body:
        if isinstance(node, ast.FunctionDef):
            for dec in node.decorator_list:
                if isinstance(dec, ast.Name) and dec.id == "_jit":
                    out.append(node)
                    break
    return out


def pair_name(twin_name: str) -> str:
    """Expected C counterpart name for a twin function."""
    if twin_name in PAIR_OVERRIDES:
        return PAIR_OVERRIDES[twin_name]
    return twin_name.lstrip("_")
