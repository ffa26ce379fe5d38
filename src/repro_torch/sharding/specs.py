"""Parameter / optimizer / batch / cache sharding specs
(``repro.sharding.specs``), on ``torch.distributed`` device meshes.

A spec is what the reference's ``PartitionSpec`` holds: one entry per
tensor dim, ``None`` (unsharded), a mesh axis name, or a tuple of axis
names (the dim split over those axes, the first one major).  The rules are
the reference's, verbatim: for every weight the "wide" structural dim
(d_ff, heads, experts, vocab, d_inner, lru width) shards over ``model``
and the d_model-ish dim over ``data`` (FSDP); any dim that does not divide
its mesh axis stays unsharded (no uneven sharding), so every architecture
places on the same mesh.  Stacked-layer leaves get a leading ``None`` for
the repeats axis.

The rules read only the mesh's axis names and sizes: ``mesh`` is a
``DeviceMesh`` or a ``{axis: size}`` dict.  :func:`placements` turns a
spec into DTensor placements on a ``DeviceMesh``: each axis that shards
tensor dim ``i`` becomes ``Shard(i)`` on that mesh dim.

Paths are the port's flat leaf paths (:func:`repro_torch.tree.
leaves_with_path`), which are the reference's pytree paths
(``stage0/u0/mixer/wq``).
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Tuple

from ..configs.base import ArchConfig
from ..tree import leaves_with_path

Spec = Tuple[object, ...]


def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` (or of such a dict)."""
    if isinstance(mesh, dict):
        return mesh
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _div(n: int, mesh: Dict[str, int], axis) -> Optional[str]:
    if axis is None or axis not in mesh:
        return None
    return axis if n % mesh[axis] == 0 else None


#: (regex on path, spec builder taking (shape, mesh) -> tuple of axis names)
_RULES = [
    # embeddings / head
    (r"embed/table$", lambda s, m: (_div(s[0], m, "model"),
                                    _div(s[1], m, "data"))),
    (r"lm_head/w$", lambda s, m: (_div(s[0], m, "data"),
                                  _div(s[1], m, "model"))),
    # MoE experts: E over model (EP), d_model over data
    (r"ffn/(gate_w|up_w)$", lambda s, m: (_div(s[0], m, "model"),
                                          _div(s[1], m, "data"), None)),
    (r"ffn/down_w$", lambda s, m: (_div(s[0], m, "model"), None,
                                   _div(s[2], m, "data"))),
    (r"ffn/router$", lambda s, m: (_div(s[0], m, "data"), None)),
    # dense FFN (and MoE shared experts)
    (r"(ffn|shared)(/shared)?/(gate|up)/w$",
     lambda s, m: (_div(s[0], m, "data"), _div(s[1], m, "model"))),
    (r"(ffn|shared)(/shared)?/down/w$",
     lambda s, m: (_div(s[0], m, "model"), _div(s[1], m, "data"))),
    # attention projections [D, H, hd] / [H, hd, D]: shard heads over model
    # when divisible, else fall back to the head_dim axis
    (r"(mixer|cross)/w[qkv]$",
     lambda s, m: (_div(s[0], m, "data"), _div(s[1], m, "model"),
                   None if s[1] % m.get("model", 1) == 0
                   else _div(s[2], m, "model"))),
    (r"(mixer|cross)/wo$",
     lambda s, m: (_div(s[0], m, "model"),
                   None if s[0] % m.get("model", 1) == 0
                   else _div(s[1], m, "model"),
                   _div(s[2], m, "data"))),
    # MLA
    (r"mixer/wdq$", lambda s, m: (_div(s[0], m, "data"), None)),
    (r"mixer/wuq$", lambda s, m: (None, _div(s[1], m, "model"), None)),
    (r"mixer/wdkv$", lambda s, m: (_div(s[0], m, "data"), None)),
    (r"mixer/wkr$", lambda s, m: (_div(s[0], m, "data"), None)),
    (r"mixer/w(uk|uv)$", lambda s, m: (None, _div(s[1], m, "model"), None)),
    # mamba2 (separate per-component projections; B/C/dt stay replicated-out)
    (r"mixer/(w_gate|w_x|w_dt)$", lambda s, m: (_div(s[0], m, "data"),
                                                _div(s[1], m, "model"))),
    (r"mixer/w_[bc]$", lambda s, m: (_div(s[0], m, "data"), None)),
    (r"mixer/out_proj$", lambda s, m: (_div(s[0], m, "model"),
                                       _div(s[1], m, "data"))),
    (r"mixer/conv_x_w$", lambda s, m: (None, _div(s[1], m, "model"))),
    (r"mixer/conv_x_b$", lambda s, m: (_div(s[0], m, "model"),)),
    (r"mixer/conv_[bc]_[wb]$", lambda s, m: tuple(None for _ in s)),
    (r"mixer/(dt_bias|a_log|d_skip)$",
     lambda s, m: (_div(s[0], m, "model"),)),
    (r"mixer/gate_norm/scale$", lambda s, m: (_div(s[0], m, "model"),)),
    # RG-LRU
    (r"mixer/w[xy]$", lambda s, m: (_div(s[0], m, "data"),
                                    _div(s[1], m, "model"))),
    (r"mixer/out$", lambda s, m: (_div(s[0], m, "model"),
                                  _div(s[1], m, "data"))),
    (r"mixer/gate_[ai]$", lambda s, m: (_div(s[0], m, "model"), None, None)),
    (r"mixer/(gate_[ai]_b|a_param)$",
     lambda s, m: (_div(s[0], m, "model"),)),
]

_COMPILED = [(re.compile(pat), fn) for pat, fn in _RULES]


def param_spec(path: str, shape: Tuple[int, ...], mesh) -> Spec:
    m = axis_sizes(mesh)
    stacked = 1 if re.search(r"(stage\d+|encoder/layers)", path) else 0
    core = tuple(shape[stacked:])
    for pat, fn in _COMPILED:
        if pat.search(path):
            spec = tuple(fn(core, m))
            if len(spec) < len(core):           # rank-robust fallback
                spec = spec + (None,) * (len(core) - len(spec))
            return (None,) * stacked + spec[:len(core)]
    return (None,) * len(shape)                 # replicate (norms, biases)


def param_shardings(params, mesh) -> Dict[str, Spec]:
    """Specs of every leaf of a parameter tree, by path."""
    return {path: param_spec(path, tuple(leaf.shape), mesh)
            for path, leaf in leaves_with_path(params)}


def unit_shardings(specs: Dict[str, Spec], stage_key: str) -> Dict[str, Spec]:
    """Specs for one repeat of a stage's unit: the stage's leaves, paths
    relative to it, the leading (stacked-layers) entry dropped."""
    pre = stage_key + "/"
    return {path[len(pre):]: spec[1:] for path, spec in specs.items()
            if path.startswith(pre)}


def unit_struct(shapes: Dict[str, Tuple[int, ...]], stage_key: str
                ) -> Dict[str, Tuple[int, ...]]:
    """Shapes for one repeat (the stacked axis dropped)."""
    pre = stage_key + "/"
    return {path[len(pre):]: tuple(shape[1:])
            for path, shape in shapes.items() if path.startswith(pre)}


# ------------------------------------------------------------------ batches
def _size(mesh: Dict[str, int], axes) -> int:
    n = 1
    for a in axes:
        n *= mesh[a]
    return n


def batch_spec(shape: Tuple[int, ...], mesh, cfg: ArchConfig,
               profile: str) -> Spec:
    """One batch leaf's spec (``repro.sharding.specs.batch_shardings``)."""
    m = axis_sizes(mesh)
    batch_axes = tuple(a for a in ("pod", "data") if a in m)
    full_axes = batch_axes + (("model",) if "model" in m else ())
    rest = [None] * (len(shape) - 1)
    full_ok = profile == "tp" or cfg.moe is None
    if full_ok and shape[0] % _size(m, full_axes) == 0:
        # recurrent-arch training: batch over the whole mesh
        return (full_axes, *rest)
    b = batch_axes if (batch_axes and shape[0] % _size(m, batch_axes) == 0) \
        else None
    if profile == "cp" and len(shape) >= 2:
        rest[0] = _div(shape[1], m, "model")
    return (b, *rest)


def batch_shardings(batch_shapes: Dict[str, Tuple[int, ...]], mesh,
                    cfg: ArchConfig, profile: str) -> Dict[str, Spec]:
    """Specs of a batch, from ``{name: shape}``."""
    return {k: batch_spec(tuple(s), mesh, cfg, profile)
            for k, s in batch_shapes.items()}


# ------------------------------------------------------------------- caches
def cache_spec(path: str, shape: Tuple[int, ...], mesh) -> Spec:
    """One decode-cache leaf's spec: batch over the data axes; the long axis
    (cache sequence, SSD heads, RG-LRU channels) over ``model``.  ``path``
    is the leaf's path in the cache tree (``stage0/u0/k``)."""
    m = axis_sizes(mesh)
    batch_axes = tuple(a for a in ("pod", "data") if a in m)
    # leading stacked-layers axis, then batch
    b = batch_axes if (len(shape) > 1 and
                       shape[1] % _size(m, batch_axes) == 0) else None
    dims = [None, b] + [None] * (len(shape) - 2)
    if re.search(r"(^|/)(k|v|c_kv|k_rope)$", path) and len(shape) >= 3:
        dims[2] = _div(shape[2], m, "model")     # cache sequence
    elif path.endswith("ssm") and len(shape) == 5:
        dims[2] = _div(shape[2], m, "model")     # SSD heads
    elif path.endswith("/h") and len(shape) == 3:
        dims[2] = _div(shape[2], m, "model")     # RG-LRU channels
    elif (path.endswith("conv") or path.endswith("conv_x")) \
            and len(shape) == 4:
        dims[3] = _div(shape[3], m, "model")     # conv channels
    # cross-attention caches: the same rule matches their k/v leaves
    return tuple(dims)


def cache_shardings(caches, mesh) -> Dict[str, Spec]:
    """Specs of every leaf of a cache tree (tensors or shapes), by path."""
    return {path: cache_spec(path, tuple(getattr(leaf, "shape", leaf)), mesh)
            for path, leaf in leaves_with_path(caches)}


# --------------------------------------------------------------- placements
def placements(spec: Spec, mesh) -> list:
    """DTensor placements on ``mesh`` (a ``DeviceMesh``) for ``spec``."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            out[names.index(axis)] = Shard(dim)
    return out
