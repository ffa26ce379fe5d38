"""Step-function builders (``repro.launch.steps``): train, prefill and
decode steps, on one device or sharded over a device mesh, and the
per-unit probes of the dry-run.

These are the units the scheduler dispatches: a job is N repetitions of
one of these steps, so profiling the first steady invocation (the paper's
structural runtime prediction) predicts the job.

With a ``mesh`` (a ``torch.distributed`` ``DeviceMesh`` with the
reference's axis names) every step takes DTensors: the stacked parameters
placed by :func:`repro_torch.sharding.specs.param_spec` (:func:`place`),
the optimizer state beside them, the batch by ``batch_spec`` and the
caches by ``cache_spec`` (the prefill step makes them so).  The model runs
under the :class:`~repro_torch.sharding.annotate.Sharder` of the arch's
profile, plain tensors in it (positions, masks) taken as replicated, and
every kernel runs inside ``local_map`` on each rank's shard.  Each bundle
carries its argument structs (:class:`Struct`: global shape, dtype,
spec), which the dry-run places as fake shards.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch

from ..configs.base import ArchConfig
from ..configs.shapes import InputShape
from ..data import pipeline as data_pipeline
from ..models import lm
from ..models.bridge import leaf_dtype
from ..optim import adamw
from ..sharding.annotate import NULL_SHARDER, Sharder, profile_for
from ..sharding.specs import (
    batch_spec,
    cache_spec,
    param_spec,
    placements,
)
from ..tree import leaves, leaves_with_path, tree_map
from .mesh import batch_axes_of


@dataclass(frozen=True)
class Struct:
    """An argument's global shape, dtype and spec (None: one device); a
    leaf of the trees of :mod:`repro_torch.tree`."""

    shape: Tuple[int, ...]
    dtype: torch.dtype
    spec: Optional[tuple] = None


@dataclass
class StepBundle:
    """A step function, what it is, and its argument structs (one tree of
    :class:`Struct` per positional argument)."""

    fn: Callable
    kind: str
    arg_specs: Tuple = ()


# ------------------------------------------------------------------ structs
def _nest(flat: Dict[str, object]) -> Dict:
    """``{"a/b": x}`` -> ``{"a": {"b": x}}``."""
    out: Dict = {}
    for path, leaf in flat.items():
        *head, last = path.split("/")
        node = out
        for key in head:
            node = node.setdefault(key, {})
        node[last] = leaf
    return out


def param_struct(cfg: ArchConfig, mesh=None,
                 dtype: torch.dtype = torch.float32) -> Dict:
    """The stacked parameter tree as :class:`Struct` leaves (the
    reference's ``eval_shape`` of ``init``): shapes from
    ``lm.param_shapes``, matrices in ``dtype`` (fp32 master weights for
    training), norms and the fp32 leaves in fp32; nothing is allocated."""
    return _nest({path: Struct(tuple(shape), leaf_dtype(path, dtype),
                               param_spec(path, shape, mesh)
                               if mesh is not None else None)
                  for path, (shape, _) in lm.param_shapes(cfg).items()})


def _batch_struct(cfg: ArchConfig, shape: InputShape, mesh) -> Dict:
    return {k: Struct(s, dt, batch_spec(s, mesh, cfg, profile_for(cfg))
                      if mesh is not None else None)
            for k, (s, dt) in data_pipeline.batch_spec(cfg, shape).items()}


def cache_struct(cfg: ArchConfig, batch: int, max_seq: int, mesh=None,
                 dtype: torch.dtype = torch.bfloat16) -> Dict:
    """The caches a prefill of ``max_seq`` positions leaves, as
    :class:`Struct` leaves (see :mod:`repro_torch.models.lm`)."""
    flat: Dict[str, Tuple[Tuple[int, ...], torch.dtype]] = {}
    for si, stage in enumerate(lm.build_plan(cfg)):
        for ui, spec in enumerate(stage.unit):
            pre, L = f"stage{si}/u{ui}", (stage.repeats, batch)
            if spec.mixer in ("gqa", "local"):
                slots = lm._window(cfg, spec) or max_seq
                kv = L + (slots, cfg.n_kv_heads, cfg.head_dim_)
                flat.update({f"{pre}/k": (kv, dtype), f"{pre}/v": (kv, dtype)})
            elif spec.mixer == "mla":
                m = cfg.mla
                flat[f"{pre}/c_kv"] = (L + (max_seq, m.kv_lora_rank), dtype)
                flat[f"{pre}/k_rope"] = (L + (max_seq, m.qk_rope_dim), dtype)
            elif spec.mixer == "ssd":
                s = cfg.ssm
                gn = s.n_groups * s.state_dim
                flat[f"{pre}/ssm"] = (L + (s.d_inner // s.head_dim,
                                           s.head_dim, s.state_dim),
                                      torch.float32)
                for name, c in (("conv_x", s.d_inner), ("conv_b", gn),
                                ("conv_c", gn)):
                    flat[f"{pre}/{name}"] = (L + (s.conv_width - 1, c), dtype)
            else:
                r = cfg.rglru
                flat[f"{pre}/h"] = (L + (r.width,), torch.float32)
                flat[f"{pre}/conv"] = (L + (r.conv_width - 1, r.width), dtype)
            if spec.cross:
                kv = L + (cfg.encoder.n_frames, cfg.n_kv_heads,
                          cfg.head_dim_)
                flat[f"{pre}/cross/k"] = (kv, dtype)
                flat[f"{pre}/cross/v"] = (kv, dtype)
    return _nest({p: Struct(s, dt, cache_spec(p, s, mesh)
                            if mesh is not None else None)
                  for p, (s, dt) in flat.items()})


def _token_struct(batch: int, mesh, dtype: torch.dtype) -> Struct:
    spec = None
    if mesh is not None:
        baxes = batch_axes_of(mesh)
        size = math.prod(mesh.size(list(mesh.mesh_dim_names).index(a))
                         for a in baxes)
        spec = (baxes,) if baxes and batch % size == 0 else (None,)
    return Struct((batch,), dtype, spec)


# ---------------------------------------------------------------- placing
def place(tree, mesh, specs: Optional[Dict[str, tuple]] = None):
    """A tree of tensors as DTensors on ``mesh``: each leaf distributed by
    its spec in ``specs`` (by path) or, without ``specs``, by
    ``param_spec``.  A leaf that requires grad stays a leaf that does."""
    from torch.distributed.tensor import distribute_tensor

    flat = dict(leaves_with_path(tree))

    def one(path, t):
        spec = specs[path] if specs is not None \
            else param_spec(path, tuple(t.shape), mesh)
        d = distribute_tensor(t.detach(), mesh, placements(spec, mesh))
        return d.requires_grad_(t.requires_grad)

    placed = {path: one(path, t) for path, t in flat.items()}
    return _rebuild(tree, placed)


def _rebuild(tree, flat: Dict[str, object], prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _rebuild(v, flat, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    return flat[prefix]


def batch_specs(cfg: ArchConfig, batch: Dict, mesh) -> Dict[str, tuple]:
    """Specs of a batch's entries on ``mesh``."""
    return {k: batch_spec(tuple(v.shape), mesh, cfg, profile_for(cfg))
            for k, v in batch.items()}


def token_spec(batch: int, mesh) -> tuple:
    """Spec of the decode step's ``token`` and ``lengths`` [B]."""
    return _token_struct(batch, mesh, torch.int32).spec


def _sharder(mesh, cfg: ArchConfig):
    if mesh is None:
        return NULL_SHARDER
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch.distributed DeviceMesh "
                        f"(sharding), got {type(mesh).__name__}")
    return Sharder(mesh, profile_for(cfg), batch_axes_of(mesh),
                   full_dp=cfg.moe is None)


def _spmd(mesh):
    """Under a mesh, plain tensors in the model (positions, masks, the
    optimizer's scalars) are taken as replicated."""
    if mesh is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication

    return implicit_replication()


#: Gradient-accumulation factor per arch for the train_4k cell: splits the
#: global batch into M sequential microbatches, dividing activation-linked
#: memory by ~M at identical tokens/step (the reference's table).
TRAIN_MICROBATCHES = {
    "dbrx-132b": 4,     # MoE keeps the CP plan; memory needs grad accumulation
    "mamba2-2.7b": 4,   # only when the full-mesh DP plan cannot engage
}


def train_microbatches(cfg: ArchConfig, shape: InputShape, mesh) -> int:
    """Gradient-accumulation factor: 1 when the full-mesh DP plan engages
    (it already minimizes activation memory), else the per-arch table."""
    if mesh is None:
        return 1
    total = mesh.size()
    if cfg.moe is None and shape.global_batch % total == 0:
        return 1
    M = TRAIN_MICROBATCHES.get(cfg.arch_id, 1)
    return M if shape.global_batch % max(M, 1) == 0 else 1


def _microbatch(shard, batch: Dict, i: int, M: int) -> Dict:
    """Microbatch ``i`` of ``M``: rows ``i``/M of the batch, or under a mesh
    each rank's ``i``-th slice of its local rows (another split of the
    rows than the reference's; the summed gradient is the same)."""
    if shard.mesh is None:
        return {k: v.chunk(M, dim=0)[i] for k, v in batch.items()}
    from torch.distributed.tensor.experimental import local_map

    out = {}
    for k, v in batch.items():
        if v.to_local().shape[0] % M:
            raise ValueError(f"{M} microbatches do not split the "
                             f"{v.to_local().shape[0]} local rows of {k!r}")
        fn = local_map(lambda t: t.chunk(M, dim=0)[i].contiguous(),
                       out_placements=list(v.placements),
                       in_placements=(v.placements,),
                       device_mesh=shard.mesh)
        out[k] = fn(v)
    return out


# ------------------------------------------------------------------- train
def build_train_step(cfg: ArchConfig, shape: InputShape, mesh=None,
                     opt_cfg: adamw.OptConfig = adamw.OptConfig(),
                     backend: str = "kernel", remat: bool = True,
                     microbatches: Optional[int] = None) -> StepBundle:
    """One optimizer step over ``M`` microbatches (``microbatches``, else
    :func:`train_microbatches`): the gradients of each are summed in fp32,
    each divided by M, before one AdamW update.  The params are the
    stacked tree with ``requires_grad`` set (``lm.init(..., stacked=True)``,
    under a mesh :func:`place`-d); the step updates them and the optimizer
    state in place and returns them with the metrics ``nll``, ``aux``,
    ``z`` (of the last microbatch), ``grad_norm`` and ``lr``, as 0-d
    tensors on the device.  Under a mesh each gradient is redistributed to
    its parameter's placements before the update."""
    shard = _sharder(mesh, cfg)
    M = microbatches if microbatches is not None \
        else train_microbatches(cfg, shape, mesh)
    if shape.global_batch % max(M, 1):
        M = 1

    def grads_of(params, batch):
        ps = leaves(params)
        total, metrics = lm.loss_fn(cfg, params, batch, backend=backend,
                                    shard=shard, remat=remat)
        grads = torch.autograd.grad(total, ps)
        if mesh is not None:
            grads = tuple(g.redistribute(p.device_mesh, p.placements)
                          for g, p in zip(grads, ps))
        return grads, metrics

    def train_step(params, opt_state, batch):
        ps = leaves(params)
        with _spmd(mesh):
            if M <= 1:
                grads, metrics = grads_of(params, batch)
            else:
                grads = [torch.zeros_like(p, dtype=torch.float32)
                         for p in ps]
                for i in range(M):
                    g, metrics = grads_of(params,
                                          _microbatch(shard, batch, i, M))
                    for acc, gi in zip(grads, g):
                        acc.add_(gi.float() / M)
            # grads and leaves in the order of the state's m and v
            _, opt_state, stats = adamw.update(list(grads), opt_state, ps,
                                               opt_cfg)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return params, opt_state, dict(metrics, **stats)

    p_struct = param_struct(cfg, mesh)
    f32 = tree_map(lambda s: Struct(s.shape, torch.float32, s.spec), p_struct)
    o_struct = {"m": f32, "v": f32, "step": Struct((), torch.int32, ())}
    return StepBundle(train_step, "train",
                      (p_struct, o_struct, _batch_struct(cfg, shape, mesh)))


# ----------------------------------------------------------------- prefill
def build_prefill_step(cfg: ArchConfig, shape: InputShape, mesh=None,
                       backend: str = "kernel",
                       max_seq: Optional[int] = None) -> StepBundle:
    """``(params, batch) -> (last-token logits, caches)`` through
    :func:`lm.prefill`; serving params (matrices in bf16), stacked."""
    shard = _sharder(mesh, cfg)
    max_seq = max_seq or shape.seq_len

    def prefill_step(params, batch):
        with _spmd(mesh):
            return lm.prefill(cfg, params, batch["tokens"], max_seq=max_seq,
                              patches=batch.get("patches"),
                              enc_frames=batch.get("frames"),
                              backend=backend, shard=shard)

    return StepBundle(prefill_step, "prefill",
                      (param_struct(cfg, mesh, torch.bfloat16),
                       _batch_struct(cfg, shape, mesh)))


# ------------------------------------------------------------------ decode
def build_decode_step(cfg: ArchConfig, shape: InputShape, mesh=None,
                      backend: str = "kernel") -> StepBundle:
    """serve_step: one new token for every sequence, KV cache of seq_len:
    ``(params, token, caches, lengths) -> (logits, caches)``, the caches
    updated in place."""
    shard = _sharder(mesh, cfg)
    B = shape.global_batch

    def decode(params, token, caches, lengths):
        with _spmd(mesh):
            return lm.decode_step(cfg, params, token, caches, lengths,
                                  backend=backend, shard=shard)

    tok = _token_struct(B, mesh, torch.int64)
    return StepBundle(decode, "decode",
                      (param_struct(cfg, mesh, torch.bfloat16), tok,
                       cache_struct(cfg, B, shape.seq_len, mesh),
                       Struct((B,), torch.int32, tok.spec)))


def build_step(cfg: ArchConfig, shape: InputShape, mesh=None,
               backend: str = "kernel", **kw) -> StepBundle:
    if shape.kind == "train":
        return build_train_step(cfg, shape, mesh, backend=backend, **kw)
    if shape.kind == "prefill":
        return build_prefill_step(cfg, shape, mesh, backend=backend, **kw)
    return build_decode_step(cfg, shape, mesh, backend=backend, **kw)


# ========================================================= per-layer probes
def _strip(tree):
    """Structs of one repeat: the stacked axis dropped."""
    return tree_map(lambda s: Struct(s.shape[1:], s.dtype,
                                     None if s.spec is None else s.spec[1:]),
                    tree)


def build_unit_probes(cfg: ArchConfig, shape: InputShape, mesh=None,
                      backend: str = "kernel"
                      ) -> Dict[str, Tuple[StepBundle, int]]:
    """One repeat of each stage's unit (and of the encoder's layer) as a
    step of its own, with how often the whole step runs it: the train
    probe runs the unit's forward and backward of ``sum(y**2) + aux``
    under remat, prefill its forward with cache entries, decode one decode
    unit.  The reference compiles them because XLA's cost analysis counts
    a loop body once; the port's dry-run traces the whole step eagerly, so
    its probes give the per-unit view and a consistency check (every
    repeat of a unit costs what its probe costs)."""
    shard = _sharder(mesh, cfg)
    plan = lm.build_plan(cfg)
    train = shape.kind == "train"
    p_struct = param_struct(cfg, mesh, torch.float32 if train
                            else torch.bfloat16)
    B = shape.global_batch
    M = 1
    if train and mesh is not None:
        M = train_microbatches(cfg, shape, mesh)
        B = B // M          # probes see per-microbatch shapes
    S_tot = shape.seq_len + (cfg.n_patches or 0)
    D = cfg.d_model

    def act(shape_, spec_fn):
        return Struct(shape_, torch.bfloat16,
                      spec_fn(shape_) if mesh is not None else None)

    def x_spec(s):
        return batch_spec(s, mesh, cfg, profile_for(cfg))

    x_struct = act((B, S_tot, D), x_spec)
    enc_struct = act((B, cfg.encoder.n_frames, D), x_spec) \
        if cfg.encoder is not None else None
    probes: Dict[str, Tuple[StepBundle, int]] = {}

    for si, stage in enumerate(plan):
        key = f"stage{si}"
        u_struct = _strip(p_struct[key])
        has_cross = cfg.encoder is not None
        if shape.kind in ("train", "prefill"):
            def probe(up, x, enc_out=None, stage=stage):
                with _spmd(mesh):
                    if not train:
                        return lm.apply_unit(cfg, stage, up, x,
                                             enc_out=enc_out,
                                             max_seq=shape.seq_len,
                                             backend=backend, shard=shard)

                    def f(up, x):
                        y, _, aux = lm.apply_unit(cfg, stage, up, x,
                                                  enc_out=enc_out,
                                                  backend=backend,
                                                  shard=shard)
                        return torch.sum(y.float() ** 2) + aux

                    ups = leaves(up)
                    total = torch.utils.checkpoint.checkpoint(
                        f, up, x, use_reentrant=False)
                    return total, torch.autograd.grad(total, ups + [x])

            args = (u_struct, x_struct) + ((enc_struct,) if has_cross else ())
        else:
            c_struct = _strip(cache_struct(cfg, B, shape.seq_len, mesh)[key])

            def probe(up, c, x, lengths, stage=stage):
                with _spmd(mesh):
                    return lm.decode_unit(cfg, stage, up, c, x, lengths,
                                          backend=backend, shard=shard)

            tok = _token_struct(B, mesh, torch.int32)
            xd = Struct((B, D), torch.bfloat16,
                        None if mesh is None else tok.spec + (None,))
            args = (u_struct, c_struct, xd, tok)
        probes[key] = (StepBundle(probe, f"probe-{shape.kind}", args),
                       stage.repeats * M)

    # encoder probe (whisper): one layer over the frame sequence
    if cfg.encoder is not None and shape.kind in ("train", "prefill"):
        enc_u = _strip(p_struct["encoder"]["layers"])

        def enc_probe(up, x):
            with _spmd(mesh):
                if not train:
                    return lm.encoder_unit(cfg, up, x, backend=backend,
                                           shard=shard)

                def f(up, x):
                    y = lm.encoder_unit(cfg, up, x, backend=backend,
                                        shard=shard)
                    return torch.sum(y.float() ** 2)

                total = torch.utils.checkpoint.checkpoint(
                    f, up, x, use_reentrant=False)
                return total, torch.autograd.grad(total, leaves(up) + [x])

        probes["encoder"] = (
            StepBundle(enc_probe, f"probe-{shape.kind}", (enc_u, enc_struct)),
            cfg.encoder.n_layers * M)
    return probes

