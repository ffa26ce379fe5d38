"""Assigned input shapes and the (arch x shape) cell matrix.

LM transformer shapes are seq_len x global_batch.  ``decode_*`` / ``long_*``
lower ``serve_step`` (one new token against a KV cache of seq_len), NOT
``train_step``.  ``long_500k`` requires sub-quadratic attention and runs
only for the SSM/hybrid architectures; the skip for full-attention archs is
recorded in DESIGN.md §Arch-applicability and surfaces as a "skipped" cell.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

from .base import ArchConfig


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode


SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}

SHAPE_ORDER = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def shape_applicable(cfg: ArchConfig, shape: InputShape) -> Tuple[bool, str]:
    """Whether this (arch x shape) cell runs, and why not if it doesn't."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "long_500k requires sub-quadratic context (full-attention arch)"
    return True, ""


def shapes_for(cfg: ArchConfig) -> List[InputShape]:
    return [SHAPES[n] for n in SHAPE_ORDER if shape_applicable(cfg, SHAPES[n])[0]]


def all_cells() -> List[Tuple[str, str, bool, str]]:
    """Every assigned (arch, shape) cell with applicability."""
    from .registry import ARCHS
    out = []
    for arch_id, cfg in ARCHS.items():
        for name in SHAPE_ORDER:
            ok, why = shape_applicable(cfg, SHAPES[name])
            out.append((arch_id, name, ok, why))
    return out
