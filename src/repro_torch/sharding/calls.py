"""The model's kernel calls and collectives under a mesh.

Under a :class:`~repro_torch.sharding.annotate.Sharder` the model's tensors
are DTensors.  Each kernel call here goes through ``local_map``: its inputs
are redistributed to the placements the call needs, the wrapped function
gets each rank's local tensors and calls :mod:`repro_torch.kernels.ops`
on them (which hands the kernel plain tensors, once per simulated rank
under ``LocalTensorMode``), and the results come back as DTensors.  What
each rank computes:

* flash attention (:func:`flash_attention`): under the cp plan, queries
  sequence-sharded over ``model`` against the whole (gathered) K/V, each
  rank at its global query offset; else heads over ``model`` where both
  head counts divide it, else replicated over ``model``;
* decode attention (:func:`write_token`, :func:`decode_attention`): each
  rank holds a slice of the sequence-sharded cache, writes the new
  token's K/V only if it owns the token's slot, attends to its slice
  (the kernel with its lse, local length ``clamp(length - r S_l, 0,
  S_l)``, lse -inf where that is 0), and the slices are combined over
  ``model`` by log-sum-exp;
* the SSD and RG-LRU scans and their decode steps (:func:`ssd`,
  :func:`ssd_decode_step`, :func:`rglru`, :func:`rglru_decode_step`):
  heads or channels over ``model`` where the batch leaves it free;
* the expert-parallel MoE (:func:`moe_expert_parallel`, the reference's
  ``_moe_shard_map``): local routing and capacity dispatch, one
  ``all_to_all`` to the expert shards over ``model``, the expert weights
  gathered over ``data``, one ``all_to_all`` back; at one token a row the
  reference's per-row dispatch on the local rows (:func:`moe_rows`);
* cache writes (:func:`store`): a prefill's per-layer entry into the
  stacked, possibly sequence-sharded cache, in place;
* the products with a weight (:func:`linear`, :func:`project`,
  :func:`unproject`) and the embedding (:func:`embed`): one local product
  or lookup per rank, the weight's rows or columns sharded where the
  activation's layout allows (Megatron-style), gathered elsewhere.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F

from ..kernels import ops
from ..kernels.local import coordinate, each_rank
from .specs import placements


def _local_map_on(mesh, fn: Callable, out_pl, in_pl: Sequence):
    """``local_map`` of ``fn`` on ``mesh``, its inputs redistributed to
    ``in_pl`` (None for a non-tensor argument).

    An input replicated over a mesh dim that another input is sharded over
    (a weight beside sharded tokens, K/V beside sequence-sharded queries)
    gets its gradient as a partial sum over that dim: each rank's local
    backward holds only its shard's contribution."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    sharded = [any(p is not None and not isinstance(p[d], Replicate)
                   for p in in_pl) for d in range(mesh.ndim)]
    grads = tuple(None if p is None else [
        Partial() if isinstance(q, Replicate) and sharded[d] else q
        for d, q in enumerate(p)] for p in in_pl)
    return local_map(fn, out_placements=out_pl, in_placements=tuple(in_pl),
                     in_grad_placements=grads, device_mesh=mesh,
                     redistribute_inputs=True)


def _local_map(shard, fn: Callable, out_specs, in_specs: Sequence):
    """:func:`_local_map_on` with specs turned into placements; a spec of
    None passes a non-tensor argument (or, as ``out_specs``, returns what
    ``fn`` returns), a list of ``out_specs`` one per output."""
    def pl(spec):
        return None if spec is None else placements(spec, shard.mesh)

    out = tuple(pl(s) for s in out_specs) if isinstance(out_specs, list) \
        else pl(out_specs)
    return _local_map_on(shard.mesh, fn, out, [pl(s) for s in in_specs])


def _n_model(shard) -> int:
    return shard._axis_size(shard.model_axis) if shard.model_axis else 1


def _model_for(shard, b: int, *dims: int):
    """The model axis if the batch plan leaves it free and it divides every
    one of ``dims``, else None."""
    _, model_free = shard._plan(b)
    n = _n_model(shard)
    if model_free and shard.model_axis and all(d % n == 0 for d in dims):
        return shard.model_axis
    return None


# ------------------------------------------------------- head projections
def linear(x, w, shard_out: bool = True):
    """``x @ w`` of DTensors, ``x`` [..., K] and ``w`` [K, N], as one local
    product per rank, Megatron-style: where ``x`` holds K sharded over a
    mesh dim, ``w``'s rows are sharded the same way and the product is a
    partial sum there; where ``x`` leaves ``model`` free and N divides it
    (and ``shard_out``), ``w``'s columns and the product's shard over
    ``model``; ``w`` is gathered over every other mesh dim (FSDP).  ``x``'s
    leading dims keep their placements.  (DTensor's own product views
    [B, S, K] as [B S, K], which older DTensor refuses for a sequence
    sharded over ``model``.)"""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = x.device_mesh
    last = x.ndim - 1
    x_pl = _settled(x, x.ndim)
    k_dims = [isinstance(pl, Shard) and pl.dim == last for pl in x_pl]
    names = list(mesh.mesh_dim_names)
    cols = shard_out and "model" in names and not k_dims[
        names.index("model")] and isinstance(x_pl[names.index("model")],
                                             Replicate) \
        and w.shape[1] % mesh.size(names.index("model")) == 0
    w_pl = [Shard(0) if k else Shard(1) if cols and name == "model"
            else Replicate() for k, name in zip(k_dims, names)]
    out_pl = [Partial() if k else Shard(last) if cols and name == "model"
              else pl for k, name, pl in zip(k_dims, names, x_pl)]
    return _local_map_on(mesh, torch.matmul, out_pl, (x_pl, w_pl))(x, w)


def _heads_on_model(x, n_heads: int) -> bool:
    """Whether [B, S, ...] ``x`` leaves the ``model`` mesh dim free and
    ``n_heads`` divides it: then a projection shards its heads there."""
    from torch.distributed.tensor import Replicate

    mesh = x.device_mesh
    names = list(mesh.mesh_dim_names)
    if "model" not in names:
        return False
    m = names.index("model")
    return isinstance(x.placements[m], Replicate) \
        and n_heads % mesh.size(m) == 0


def project(x, w):
    """``einsum("bsd,dhk->bshk")`` of DTensors as one local product per
    rank: ``x`` [B, S, D] as it is placed (its D whole), ``w`` [D, H, k]
    gathered over every axis but ``model``, which shards its heads where
    ``x`` leaves ``model`` free and H divides it.  (DTensor's own
    propagation of the flattened product can shard the product's columns,
    and a gradient sharded so cannot be unflattened into heads that do not
    divide the axis.)"""
    from torch.distributed.tensor import Replicate, Shard

    mesh = x.device_mesh
    heads = _heads_on_model(x, w.shape[1])
    names = list(mesh.mesh_dim_names)
    x_pl = _settled(x, x.ndim - 1)
    w_pl = [Shard(1) if heads and name == "model" else Replicate()
            for name in names]
    out_pl = [Shard(2) if heads and name == "model" else pl
              for name, pl in zip(names, x_pl)]

    def local(x, w):
        return (x @ w.flatten(1)).unflatten(-1, w.shape[1:])

    return _local_map_on(mesh, local, out_pl, (x_pl, w_pl))(x, w)


def _settled(x, whole: int) -> list:
    """``x``'s placements with partial sums reduced (a local product must
    see whole values; a partial input's gradient would be taken as
    partial too) and the dims from ``whole`` on gathered (contracted)."""
    from torch.distributed.tensor import Replicate, Shard

    return [Replicate() if pl.is_partial() or (isinstance(pl, Shard)
                                               and pl.dim >= whole) else pl
            for pl in x.placements]


def unproject(o, w):
    """``einsum("bshk,hkd->bsd")`` of DTensors as one local product per
    rank: ``w`` [H, k, D] gathered but for its heads, sharded over
    ``model`` as ``o``'s heads are; the result then a partial sum over
    ``model``."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = o.device_mesh
    o_pl = _settled(o, 3)
    heads = [isinstance(pl, Shard) and pl.dim == 2 for pl in o_pl]
    w_pl = [Shard(0) if h else Replicate() for h in heads]
    out_pl = [Partial() if h else pl for h, pl in zip(heads, o_pl)]

    def local(o, w):
        return o.flatten(-2) @ w.flatten(0, 1)

    return _local_map_on(mesh, local, out_pl, (o_pl, w_pl))(o, w)


def embed(table, tokens):
    """``table[tokens]`` of DTensors as a local lookup per rank: the table
    gathered (as FSDP gathers a weight), the tokens as they are placed
    (DTensor's own index strategy refuses tokens whose one dim is sharded
    over two mesh dims, as the full-mesh batch plan shards them)."""
    from torch.distributed.tensor import Replicate

    mesh = tokens.device_mesh
    tok_pl = _settled(tokens, tokens.ndim)
    return _local_map_on(mesh, lambda t, i: t[i], tok_pl,
                         ([Replicate()] * mesh.ndim, tok_pl))(table, tokens)


# ------------------------------------------------------------- attention
def attention_specs(shard, B: int, S: int, H: int, KV: int):
    """(q spec, k/v spec, whether q is sequence-sharded) for [B, S, H, D]
    queries against [B, Sk, KV, D] keys."""
    b, model_free = shard._plan(B)
    m = shard.model_axis
    if model_free and m:
        n = _n_model(shard)
        if shard.profile == "cp" and S % n == 0:
            return (b, m, None, None), (b, None, None, None), True
        if H % n == 0 and KV % n == 0:
            return (b, None, m, None), (b, None, m, None), False
    return (b, None, None, None), (b, None, None, None), False


def flash_attention(shard, q, k, v, *, mask_kind: str, window: int = 0,
                    scale: Optional[float] = None, backend: str = "kernel"):
    """:func:`ops.flash_attention` on each rank's queries ([B, S, H, D]
    DTensors in and out)."""
    B, S, H, _ = q.shape
    q_spec, kv_spec, seq = attention_specs(shard, B, S, H, k.shape[2])
    offset = _seq_offset(shard.mesh, shard.model_axis,
                         S // _n_model(shard)) if seq else 0

    def local(q, k, v):
        return ops.flash_attention(q.contiguous(), k.contiguous(),
                                   v.contiguous(), mask_kind=mask_kind,
                                   window=window, q_offset=offset,
                                   scale=scale, backend=backend)

    return _local_map(shard, local, q_spec, (q_spec, kv_spec, kv_spec))(
        q, k, v)


def _seq_offset(mesh, axis: str, S_l: int) -> Callable[[int], int]:
    """A rank's global offset into a sequence sharded over ``axis``."""
    return lambda rank: coordinate(mesh, rank)[axis] * S_l


def write_token(shard, cache, new, slot) -> None:
    """Write one token's ``new`` [B, ...] into ``cache`` [B, S, ...] (a
    view of the stacked, possibly sequence-sharded cache) at ``slot`` [B],
    in place: a row is written by the rank whose slice holds its slot."""
    mesh = shard.mesh
    b, s = _spec_of(cache)[:2]          # batch axes, sequence axis
    rest = (None,) * (new.ndim - 1)

    def per_rank(rank, c, t, slot):
        S_l = c.shape[1]
        lo = coordinate(mesh, rank)[s] * S_l if s else 0
        mine = (slot >= lo) & (slot < lo + S_l)
        rows = torch.arange(c.shape[0], device=c.device)
        at = (slot - lo).clamp(0, S_l - 1)
        keep = mine.view((-1,) + (1,) * (t.ndim - 1))
        c[rows, at] = torch.where(keep, t.to(c.dtype), c[rows, at])

    def local(c, t, slot):
        each_rank(per_rank, c, t, slot)

    _local_map(shard, local, None, (_spec_of(cache), (b,) + rest, (b,)))(
        cache, new, slot)


def decode_attention(shard, q, k_cache, v_cache, length, *,
                     window: int = 0, backend: str = "kernel"):
    """Decode attention of ``q`` [B, H, D] over a (sequence-sharded) cache
    whose slots up to the token's own are written: [B, H, Dv].  Each rank
    attends to its slice (the kernel with its lse) and the slices are
    combined over the cache's sequence axis by log-sum-exp; with a ring of
    ``window`` slots (``window`` < S) every slot is filled once the ring
    has wrapped."""
    mesh = shard.mesh
    S = k_cache.shape[1]
    b, s = _spec_of(k_cache)[:2]
    ring = bool(window) and window < S

    def per_rank(rank, q, kc, vc, length):
        S_l = kc.shape[1]
        lo = coordinate(mesh, rank)[s] * S_l if s else 0
        eff = torch.clamp(length + 1, max=window if ring else S)
        local_len = torch.clamp(eff - lo, 0, S_l).to(torch.int32)
        return ops.decode_attention(q.contiguous(), kc, vc, local_len,
                                    return_lse=True, backend=backend)

    def local(q, kc, vc, length):
        out, lse = each_rank(per_rank, q, kc, vc, length)
        return combine_slices(mesh, s, out, lse)

    row, cache = (b, None, None), _spec_of(k_cache)
    return _local_map(shard, local, row, (row, cache, cache, (b,)))(
        q, k_cache, v_cache, length)


def combine_slices(mesh, axis: Optional[str], out: torch.Tensor,
                   lse: torch.Tensor) -> torch.Tensor:
    """Attention outputs of the ``axis`` ranks' cache slices, [B, H, Dv]
    each with its lse [B, H], combined by log-sum-exp (a rank whose slice
    held no key has lse -inf and weight 0).  Over one rank the weight is
    exactly 1 and ``out`` comes back unchanged."""
    import torch.distributed._functional_collectives as funcol

    if axis is None:
        return out
    group = mesh.get_group(axis)
    n = mesh.size(list(mesh.mesh_dim_names).index(axis))
    lses = funcol.all_gather_tensor(lse.contiguous(), 0, group)
    lses = lses.view(n, *lse.shape)
    m = lses.amax(0)
    total = m + torch.log(torch.exp(lses - m).sum(0))
    w = torch.exp(lse - total)
    summed = funcol.all_reduce(out.float() * w[..., None], "sum", group)
    return summed.to(out.dtype)


# -------------------------------------------------------- recurrent scans
def _ssd_specs(shard, B: int, H: int, G: int):
    m = _model_for(shard, B, H)
    if m is not None and G != 1 and G % _n_model(shard):
        m = None
    b, _ = shard._plan(B)
    g = m if (m is not None and G != 1) else None
    return b, m, g


def ssd(shard, x, dt, A, Bmat, Cmat, *, chunk: int,
        initial_state=None, backend: str = "kernel"):
    """:func:`ops.ssd` on each rank's heads (or batch rows)."""
    B, _, H, _ = x.shape
    b, h, g = _ssd_specs(shard, B, H, Bmat.shape[2])
    xs, dts, bc = (b, None, h, None), (b, None, h), (b, None, g, None)
    st = (b, h, None, None)

    def local(x, dt, A, Bmat, Cmat, h0):
        return ops.ssd(x, dt, A, Bmat, Cmat, chunk=chunk, initial_state=h0,
                       backend=backend)

    return _local_map(shard, local, [xs, st],
                      (xs, dts, (h,), bc, bc,
                       None if initial_state is None else st))(
        x, dt, A, Bmat, Cmat, initial_state)


def ssd_decode_step(shard, x, dt, A, Bvec, Cvec, state):
    """:func:`ops.ssd_decode_step` on each rank's heads: x [B, H, P], state
    [B, H, P, N]."""
    B, H, _ = x.shape
    b, h, g = _ssd_specs(shard, B, H, Bvec.shape[1])
    return _local_map(shard, ops.ssd_decode_step,
                      [(b, h, None), (b, h, None, None)],
                      ((b, h, None), (b, h), (h,), (b, g, None),
                       (b, g, None), (b, h, None, None)))(
        x, dt, A, Bvec, Cvec, state)


def rglru(shard, x, gate_a, gate_i, log_a, *, initial_state=None,
          c: float = 8.0, backend: str = "kernel"):
    """:func:`ops.rglru` on each rank's channels (or batch rows)."""
    B, _, C = x.shape
    b, _ = shard._plan(B)
    ch = _model_for(shard, B, C)
    seq, st = (b, None, ch), (b, ch)

    def local(x, gate_a, gate_i, log_a, h0):
        return ops.rglru(x, gate_a, gate_i, log_a, initial_state=h0, c=c,
                         backend=backend)

    return _local_map(shard, local, [seq, st],
                      (seq, seq, seq, (ch,),
                       None if initial_state is None else st))(
        x, gate_a, gate_i, log_a, initial_state)


def rglru_decode_step(shard, x, gate_a, gate_i, log_a, state):
    """:func:`ops.rglru_decode_step` on each rank's channels: [B, C]."""
    B, C = x.shape
    b = shard._batch_spec(B)
    ch = _model_for(shard, B, C)
    row = (b, ch)
    return _local_map(shard, ops.rglru_decode_step, [row, row],
                      (row, row, row, (ch,), row))(
        x, gate_a, gate_i, log_a, state)


# -------------------------------------------------------------------- MoE
def route(shard, p, x, cfg, dtype):
    """The router on each rank's tokens: (probs, gates, experts, one-hot of
    the first expert), DTensors placed as ``x``'s tokens."""
    from ..models import moe as moe_mod

    spec = _spec_of(x)[:2] + (None,) * (x.ndim - 2)

    def local(x, router):
        probs, gate, idx = moe_mod.route({"router": router}, x, cfg, dtype)
        first = F.one_hot(idx[..., 0], cfg.n_experts).float()
        return probs, gate, idx, first

    return _local_map(shard, local, [spec] * 4, (spec, (None, None)))(
        x, p["router"])


def moe_expert_parallel(shard, p, x, idx, gate, cfg, dtype):
    """Expert-parallel MoE (``repro.models.moe._moe_shard_map``)."""
    import torch.distributed._functional_collectives as funcol

    mesh, axis = shard.mesh, shard.model_axis
    n = _n_model(shard)
    E = cfg.n_experts
    if E % n:
        raise ValueError(f"{E} experts do not split over {n} model ranks")
    B, S, D = x.shape
    b = shard._batch_spec(B)
    s = axis if S % n == 0 else None
    names = mesh.mesh_dim_names
    w_data = "data" if ("data" in names and
                        D % shard._axis_size("data") == 0) else None
    group = mesh.get_group(axis)

    def local(x_l, idx_l, gate_l, gw, uw, dw):
        B_l, S_l, _ = x_l.shape
        T = B_l * S_l
        cap = max(1, int(cfg.capacity_factor * cfg.top_k * T // E))
        buf, meta = ops.moe_dispatch(x_l.reshape(1, T, D),
                                     idx_l.reshape(1, T, -1),
                                     gate_l.reshape(1, T, -1), E, cap)
        # tokens -> expert shards: split E, concatenate capacity
        buf = funcol.all_to_all_single_autograd(
            buf[0].contiguous(), None, None, group)
        buf = buf.view(n, E // n, cap, D).transpose(0, 1).reshape(
            E // n, n * cap, D)
        h = torch.bmm(buf, gw.to(dtype))
        u = torch.bmm(buf, uw.to(dtype))
        h = F.silu(h.float()).to(dtype) * u
        y = torch.bmm(h, dw.to(dtype))                 # [E/n, n cap, D]
        # expert outputs -> token shards: split capacity, concatenate E
        y = y.view(E // n, n, cap, D).transpose(0, 1).contiguous()
        y = funcol.all_to_all_single_autograd(y, None, None, group)
        out = ops.moe_combine(y.view(1, E, cap, D), meta)
        return out.reshape(B_l, S_l, D).to(x_l.dtype)

    act = (b, s, None)
    return _local_map(shard, local, act,
                      (act, act, act, (axis, None, None),
                       (axis, None, None), (axis, None, None)))(
        x, idx, gate, p["gate_w"], p["up_w"], p["down_w"])


def moe_rows(shard, p, x, idx, gate, capacity: int, dtype):
    """The per-row dispatch (``ops.moe_apply``, the reference's vmapped
    capacity per (row, expert)) on each rank's rows, the experts
    gathered."""
    b = shard._batch_spec(x.shape[0])
    act = (b, None, None)
    full = (None, None, None)

    def local(x, idx, gate, gw, uw, dw):
        return ops.moe_apply(x, gw, uw, dw, idx, gate, capacity, dtype=dtype)

    return _local_map(shard, local, act, (act, act, act, full, full, full))(
        x, idx, gate, p["gate_w"], p["up_w"], p["down_w"])


# ----------------------------------------------------------------- caches
def store(shard, leaf, r: int, entry, slots: bool = False) -> None:
    """Write one layer's cache ``entry`` [B, S, ...] at repeat ``r`` of the
    stacked ``leaf`` [reps, B, slots, ...] (a DTensor), in place.  With
    ``slots`` the entry fills the first S of the leaf's sequence slots,
    which may be sharded over ``model``: each rank copies the positions
    its slice holds."""
    from torch.distributed.tensor import Shard

    spec = _spec_of(leaf)
    mesh = shard.mesh
    seq_axes = [name for name, pl in zip(mesh.mesh_dim_names,
                                         leaf.placements)
                if isinstance(pl, Shard) and pl.dim == 2]
    e_spec = tuple(spec[1:])
    if slots:
        e_spec = (e_spec[0], None) + e_spec[2:]
    S = entry.shape[1]

    def per_rank(rank, leaf_l, e_l):
        lo = 0
        if slots and seq_axes:
            lo = coordinate(mesh, rank)[seq_axes[0]] * leaf_l.shape[2]
        if slots:
            n = max(0, min(S - lo, leaf_l.shape[2]))
            leaf_l[r, :, :n] = e_l[:, lo:lo + n].to(leaf_l.dtype)
        else:
            leaf_l[r] = e_l.to(leaf_l.dtype)

    def local(leaf_l, e_l):
        each_rank(per_rank, leaf_l, e_l)

    _local_map(shard, local, None, (spec, e_spec))(leaf, entry)


def _spec_of(t):
    """A DTensor's spec (entries in mesh-dim order per tensor dim)."""
    from torch.distributed.tensor import Shard

    dims = [[] for _ in range(t.ndim)]
    for name, pl in zip(t.device_mesh.mesh_dim_names, t.placements):
        if isinstance(pl, Shard):
            dims[pl.dim].append(name)
    return tuple(None if not d else (d[0] if len(d) == 1 else tuple(d))
                 for d in dims)
