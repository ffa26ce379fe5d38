"""Load parameters into the port from flat arrays.

:func:`params_from_numpy` takes the JAX package's parameters flattened to
a ``{path: array}`` dict, as ``repro.checkpoint.checkpointer`` flattens
them (``stage0/u0/mixer/wq``; the checkpointer's sanitised form
``stage0_u0_mixer_wq`` is accepted too), and returns the port's nested
parameters (:mod:`repro_torch.models.lm`).  It is the one way the tests
share weights between the two packages, and :func:`lm.init` goes through
it as well.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

from .. import resolve_device
from ..configs.base import ArchConfig
from .layers import DEFAULT_COMPUTE_DTYPE
from .lm import build_plan, param_shapes

_SANITIZE = re.compile(r"[^A-Za-z0-9_.:-]")     # the checkpointer's rule
# Leaves the JAX package reads in float32 (ssm.py: dt_bias, a_log;
# rglru.py: a_param): rounding them to bf16 would move A, dt and log_a.
_FP32_LEAVES = ("dt_bias", "a_log", "a_param")


def leaf_dtype(path: str, dtype: torch.dtype) -> torch.dtype:
    """The dtype a parameter is kept in: float32 for norm scales and
    biases and for :data:`_FP32_LEAVES`, ``dtype`` for everything else."""
    parts = path.split("/")
    if "norm" in parts[-2] or parts[-1] in _FP32_LEAVES:
        return torch.float32
    return dtype


def params_from_numpy(cfg: ArchConfig, flat: Mapping[str, object], *,
                      device=None,
                      dtype: torch.dtype = DEFAULT_COMPUTE_DTYPE,
                      stacked: bool = False) -> Dict:
    """Nested port parameters on ``device`` from flat arrays (numpy arrays
    or tensors).  Matrices and biases are cast once to ``dtype`` (the JAX
    package casts them at every use, to the same values); norm scales and
    biases and the leaves the JAX package reads in float32 stay float32
    (:func:`leaf_dtype`).  Stacked stage parameters are split along their
    leading axis into per-layer views (the encoder's layers too), unless
    ``stacked``: then every stage unit (and ``encoder/layers``) stays one
    dict of ``[repeats, ...]`` leaves, the JAX package's
    pytree, which is what training takes (``dtype=torch.float32``: the
    reference's fp32 master weights, cast to bf16 at each use; the stacked
    tensors are the leaves that gradients, the optimizer and checkpoints
    address, and the model takes its per-layer views inside
    :func:`repro_torch.models.lm.forward`).  Raises on a missing,
    unexpected or misshapen entry."""
    device = resolve_device(device)
    shapes = param_shapes(cfg)
    by_flat = {_SANITIZE.sub("_", k): k for k in flat}
    want = {_SANITIZE.sub("_", k): k for k in shapes}
    missing = sorted(set(want) - set(by_flat))
    extra = sorted(set(by_flat) - set(want))
    if missing or extra:
        raise KeyError(f"{cfg.arch_id}: parameters missing {missing}, "
                       f"unexpected {extra}")

    nested: Dict = {}
    for san, path in want.items():
        arr = flat[by_flat[san]]
        shape = shapes[path][0]
        if tuple(arr.shape) != shape:
            raise ValueError(f"{path}: shape {tuple(arr.shape)}, expected "
                             f"{shape}")
        t = arr if torch.is_tensor(arr) else torch.from_numpy(np.array(arr))
        parts = path.split("/")
        t = t.to(device=device, dtype=leaf_dtype(path, dtype))
        node = nested
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = t

    if stacked:
        return nested
    if cfg.encoder is not None:
        enc = nested["encoder"]
        enc["layers"] = [_select(enc["layers"], r)
                         for r in range(cfg.encoder.n_layers)]
    for si, stage in enumerate(build_plan(cfg)):
        units = nested[f"stage{si}"]
        for ui in range(len(stage.unit)):
            unit = units[f"u{ui}"]
            units[f"u{ui}"] = [_select(unit, r)
                               for r in range(stage.repeats)]
    return nested


def _select(tree: Dict, r: int) -> Dict:
    return {k: _select(v, r) if isinstance(v, dict) else v[r]
            for k, v in tree.items()}
