"""The language model of the port (``repro.models.lm``).

``build_plan`` is the JAX package's, and the port runs every plan it
makes: dense GQA ``Stage((LayerSpec("gqa", "dense"),), n_layers)``
(yi-6b, yi-34b, mistral-nemo and pixtral-12b, whose precomputed patch
embeddings are prepended to the tokens), the same with cross attention
behind an encoder (whisper-large-v3: ``LayerSpec("gqa", "dense",
cross=True)``, the encoder a stack of biased, unmasked, rope-less GQA
layers over precomputed frame embeddings), the same with the MLA mixer
(minicpm3-4b), MoE plans with either mixer and an optional leading dense
stage (deepseek-v2-lite: one dense layer of width 10944, then 26 MLA +
MoE layers; dbrx: GQA + MoE), the Mamba-2 plan
``Stage((LayerSpec("ssd", "none"),), n_layers)`` (mamba2-2.7b) and the
Griffin hybrid of RG-LRU and local-attention layers (recurrentgemma-2b:
8 repeats of (rglru, rglru, local) and a second stage of (rglru, rglru)).
The JAX package scans each stage's stacked parameters (and the encoder's)
with ``lax.scan``; here the stacked parameters are split into a list of
per-layer views when they are loaded (:mod:`repro_torch.models.bridge`)
and a Python loop walks them, the encoder first, then stage after stage.

Parameters are a nested dict: ``params["stage0"]["u0"]`` is the list of
per-layer dicts of stage 0's unit 0, other leaves are as in the JAX
package (``params["embed"]["table"]`` and so on; ``params["encoder"]
["layers"]`` is the encoder's list of per-layer dicts).  For training the
unit (and the encoder's layers) is instead one dict of stacked ``[repeats,
...]`` leaves, the JAX package's pytree (``init(..., stacked=True)``):
those tensors are the autograd leaves, and :func:`forward` takes their
per-layer views itself.
Caches keep the JAX package's structure, one dict of stacked ``[L, ...]``
leaves per unit:
``{"k", "v"}`` ``[L, B, slots, KV, hd]`` for attention (``max_seq`` slots,
or exactly ``window`` for a local layer), ``{"c_kv" [L, B, max_seq, R],
"k_rope" [L, B, max_seq, r]}`` for MLA, ``{"ssm" [L, B, H, P, N] fp32,
"conv_x"/"conv_b"/"conv_c" [L, B, W-1, C]}`` for Mamba-2 and ``{"h" [L, B,
C] fp32, "conv" [L, B, W-1, C]}`` for RG-LRU; a cross-attention layer's
entry also holds ``"cross": {"k", "v"}`` [L, B, frames, KV, hd], the
encoder's keys and values.  :func:`decode_step` updates them in place.

Every entry point takes ``shard`` (the reference's sharder):
:data:`~repro_torch.sharding.annotate.NULL_SHARDER` on one device, or a
:class:`~repro_torch.sharding.annotate.Sharder` on a device mesh, where
params, batch and caches are DTensors placed by
:mod:`repro_torch.sharding.specs` and the hooks are called where the
reference calls them (activations after the embedding and after every
layer, the logits, the decode activations; the mixers' own).  Under a
mesh the caches are allocated as DTensors placed by ``cache_spec``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

from .. import prng, resolve_device
from ..configs.base import ArchConfig
from ..kernels import threefry
from ..sharding import calls
from ..sharding.annotate import NULL_SHARDER
from ..sharding.specs import cache_spec, placements
from . import attention as attn
from . import mla as mla_mod
from . import moe as moe_mod
from . import rglru as rglru_mod
from . import ssm as ssm_mod
from .layers import (
    DEFAULT_COMPUTE_DTYPE,
    apply_mlp,
    apply_norm,
    cast,
    embed,
    mm,
    unembed,
)


@dataclass(frozen=True)
class LayerSpec:
    mixer: str                  # gqa|local|mla|ssd|rglru
    ffn: str                    # dense|moe|none
    cross: bool = False
    d_ff: Optional[int] = None  # per-layer FFN width override


@dataclass(frozen=True)
class Stage:
    unit: Tuple[LayerSpec, ...]
    repeats: int


def build_plan(cfg: ArchConfig) -> Tuple[Stage, ...]:
    if cfg.ssm is not None:
        return (Stage((LayerSpec("ssd", "none"),), cfg.n_layers),)
    if cfg.rglru is not None:
        pat = tuple("rglru" if p == "rec" else "local" for p in cfg.rglru.pattern)
        unit = tuple(LayerSpec(m, "dense") for m in pat)
        full, rem = divmod(cfg.n_layers, len(pat))
        stages = [Stage(unit, full)] if full else []
        if rem:
            stages.append(Stage(unit[:rem], 1))
        return tuple(stages)
    mixer = "mla" if cfg.attn_kind == "mla" else "gqa"
    if cfg.moe is not None:
        stages = []
        nd = cfg.moe.first_dense_layers
        if nd:
            stages.append(Stage(
                (LayerSpec(mixer, "dense", d_ff=cfg.moe.d_ff_dense),), nd))
        stages.append(Stage((LayerSpec(mixer, "moe"),), cfg.n_layers - nd))
        return tuple(stages)
    return (Stage((LayerSpec(mixer, "dense", cross=cfg.encoder is not None),),
                  cfg.n_layers),)


# ================================================================== init
Init = Union[float, str]        # normal std, or the name of a fixed init


def _fixed_init(how: str, n: int) -> torch.Tensor:
    """The non-random initialisations, as vectors of length ``n``."""
    if how == "ones":
        return torch.ones(n)
    if how == "zeros":
        return torch.zeros(n)
    if how == "a_log":          # Mamba-2: A = -exp(a_log) in [-16, -1]
        return torch.log(torch.linspace(1.0, 16.0, n))
    if how == "a_param":        # RG-LRU: a = exp(-softplus(.)) in [0.9, 0.999]
        return torch.log(torch.expm1(-torch.log(
            torch.linspace(0.9, 0.999, n))))
    raise ValueError(f"unknown initialisation {how!r}")


def param_shapes(cfg: ArchConfig) -> Dict[str, Tuple[Tuple[int, ...], Init]]:
    """Every parameter by its flat path (the JAX package's pytree path,
    ``stage0/u0/mixer/wq``), with its shape and its initialisation as in
    ``repro.models.lm.init``.  Stage parameters and the encoder's layers
    carry the leading ``[repeats]`` axis, as they do there."""
    plan = build_plan(cfg)
    d, V = cfg.d_model, cfg.padded_vocab
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    bias = cfg.norm == "layer"
    s_in = 1.0 / math.sqrt(d)

    def norm(prefix: str, lead: Tuple[int, ...]) -> Dict:
        out = {f"{prefix}/scale": (lead + (d,), "ones")}
        if bias:
            out[f"{prefix}/bias"] = (lead + (d,), "zeros")
        return out

    def attention(L: Tuple[int, ...], bias: bool = bias) -> Dict:
        # attention.gqa_init; the encoder's and cross attention's
        # (attention.cross_init) are always biased
        out = {"wq": (L + (d, H, hd), s_in), "wk": (L + (d, KV, hd), s_in),
               "wv": (L + (d, KV, hd), s_in),
               "wo": (L + (H, hd, d), 1.0 / math.sqrt(H * hd))}
        if bias:
            out.update(bq=(L + (H, hd), "zeros"), bk=(L + (KV, hd), "zeros"),
                       bv=(L + (KV, hd), "zeros"), bo=(L + (d,), "zeros"))
        return out

    def mamba2(L: Tuple[int, ...]) -> Dict:           # ssm.mamba2_init
        s = cfg.ssm
        heads, di, gn = s.d_inner // s.head_dim, s.d_inner, \
            s.n_groups * s.state_dim
        return {"w_gate": (L + (d, di), s_in), "w_x": (L + (d, di), s_in),
                "w_b": (L + (d, gn), s_in), "w_c": (L + (d, gn), s_in),
                "w_dt": (L + (d, heads), s_in),
                "conv_x_w": (L + (s.conv_width, di), 0.2),
                "conv_x_b": (L + (di,), "zeros"),
                "conv_b_w": (L + (s.conv_width, gn), 0.2),
                "conv_b_b": (L + (gn,), "zeros"),
                "conv_c_w": (L + (s.conv_width, gn), 0.2),
                "conv_c_b": (L + (gn,), "zeros"),
                "dt_bias": (L + (heads,), "zeros"),
                "a_log": (L + (heads,), "a_log"),
                "d_skip": (L + (heads,), "ones"),
                "gate_norm/scale": (L + (di,), "ones"),
                "out_proj": (L + (di, d), 1.0 / math.sqrt(di))}

    def rglru(L: Tuple[int, ...]) -> Dict:            # rglru.rglru_block_init
        r = cfg.rglru
        W, nb = r.width, rglru_mod.N_GATE_BLOCKS
        blk = W // nb
        return {"wx": (L + (d, W), s_in), "wy": (L + (d, W), s_in),
                "conv_w": (L + (r.conv_width, W), 0.2),
                "conv_b": (L + (W,), "zeros"),
                "gate_a": (L + (nb, blk, blk), 1.0 / math.sqrt(blk)),
                "gate_a_b": (L + (W,), "zeros"),
                "gate_i": (L + (nb, blk, blk), 1.0 / math.sqrt(blk)),
                "gate_i_b": (L + (W,), "zeros"),
                "a_param": (L + (W,), "a_param"),
                "out": (L + (W, d), 1.0 / math.sqrt(W))}

    def mla(L: Tuple[int, ...]) -> Dict:              # mla.mla_init
        m = cfg.mla
        R, qk = m.kv_lora_rank, m.qk_nope_dim + m.qk_rope_dim
        out = {}
        if m.q_lora_rank:
            out["wdq"] = (L + (d, m.q_lora_rank), s_in)
            out["q_norm/scale"] = (L + (m.q_lora_rank,), "ones")
            out["wuq"] = (L + (m.q_lora_rank, H, qk),
                          1.0 / math.sqrt(m.q_lora_rank))
        else:
            out["wq"] = (L + (d, H, qk), s_in)
        out.update(wdkv=(L + (d, R), s_in), wkr=(L + (d, m.qk_rope_dim), s_in),
                   wuk=(L + (R, H, m.qk_nope_dim), 1.0 / math.sqrt(R)),
                   wuv=(L + (R, H, m.v_head_dim), 1.0 / math.sqrt(R)),
                   wo=(L + (H, m.v_head_dim, d),
                       1.0 / math.sqrt(H * m.v_head_dim)))
        out["kv_norm/scale"] = (L + (R,), "ones")
        return out

    def mlp(L: Tuple[int, ...], ff: int,
            act: str = cfg.act) -> Dict:              # layers.mlp_init
        if act in ("swiglu", "geglu"):
            return {"gate/w": (L + (d, ff), s_in),
                    "up/w": (L + (d, ff), s_in),
                    "down/w": (L + (ff, d), 1.0 / math.sqrt(ff))}
        return {"up/w": (L + (d, ff), s_in), "up/b": (L + (ff,), "zeros"),
                "down/w": (L + (ff, d), 1.0 / math.sqrt(ff)),
                "down/b": (L + (d,), "zeros")}

    def prefixed(prefix: str, tree: Dict) -> Dict:
        return {f"{prefix}/{key}": val for key, val in tree.items()}

    def moe(L: Tuple[int, ...]) -> Dict:              # moe.moe_init
        E, ff = cfg.moe.n_experts, cfg.d_ff
        out = {"router": (L + (d, E), s_in),
               "gate_w": (L + (E, d, ff), s_in),
               "up_w": (L + (E, d, ff), s_in),
               "down_w": (L + (E, ff, d), 1.0 / math.sqrt(ff))}
        if cfg.moe.n_shared:
            out.update(prefixed("shared", mlp(L, cfg.moe.n_shared * ff,
                                              "swiglu")))
        return out

    mixers = {"gqa": attention, "local": attention, "mla": mla, "ssd": mamba2,
              "rglru": rglru}
    shapes: Dict[str, Tuple[Tuple[int, ...], Init]] = {
        "embed/table": ((V, d), 0.02)}
    shapes.update(norm("final_norm", ()))
    if not cfg.tie_embeddings:
        shapes["lm_head/w"] = ((d, V), 0.02)
    if cfg.encoder is not None:                       # _encoder_layer_init
        L, pre = (cfg.encoder.n_layers,), "encoder/layers"
        shapes.update(norm(f"{pre}/norm1", L))
        shapes.update(prefixed(f"{pre}/mixer", attention(L, bias=True)))
        shapes.update(norm(f"{pre}/norm2", L))
        shapes.update(prefixed(f"{pre}/ffn", mlp(L, cfg.d_ff)))
        shapes.update(norm("encoder/final_norm", ()))
    for si, stage in enumerate(plan):
        for ui, spec in enumerate(stage.unit):
            L = (stage.repeats,)
            pre = f"stage{si}/u{ui}"
            shapes.update(norm(f"{pre}/norm1", L))
            shapes.update(prefixed(f"{pre}/mixer", mixers[spec.mixer](L)))
            if spec.cross:
                shapes.update(norm(f"{pre}/norm_cross", L))
                shapes.update(prefixed(f"{pre}/cross",
                                       attention(L, bias=True)))
            if spec.ffn == "none":
                continue
            shapes.update(norm(f"{pre}/norm2", L))
            ffn = moe(L) if spec.ffn == "moe" \
                else mlp(L, spec.d_ff or cfg.d_ff)
            shapes.update(prefixed(f"{pre}/ffn", ffn))
    return shapes


#: A random leaf's draw: its key (one per repeat for a stacked leaf),
#: and the factor applied to the standard normal, with whether the
#: reference divides by it (``normal / math.sqrt(n)``) or multiplies.
Draw = Tuple[list, float, bool]


def draw_keys(cfg: ArchConfig, seed: int = 0) -> Dict[str, Draw]:
    """Every random leaf of ``repro.models.lm.init(cfg, PRNGKey(seed))``
    by its flat path, with the threefry key the reference draws it from:
    ``split(key, len(plan) + 4)``; the embedding from key 0, the head from
    key 1, the encoder's layers from ``split(split(key 2, 2)[0],
    n_layers)``; stage ``si``'s unit ``ui``, repeat ``r`` from
    ``split(fold_in(key 3 + si, ui), repeats)[r]``; inside each module the
    module's own splits (``_layer_init`` 6, ``_encoder_layer_init`` 3,
    ``gqa_init`` 4, ``mlp_init`` 3, ``mla_init`` 8, ``moe_init`` 5,
    ``mamba2_init`` 8 and ``out_proj`` from ``fold_in(key, 99)``,
    ``rglru_block_init`` 6)."""
    plan = build_plan(cfg)
    d, H, hd = cfg.d_model, cfg.n_heads, cfg.head_dim_
    s_in = 1.0 / math.sqrt(d)

    def mul(k, scale):
        return k, scale, False

    def div(k, n):
        return k, math.sqrt(n), True

    def gqa(k) -> Dict:                               # attention.gqa_init
        ks = prng.split(k, 4)
        return {"wq": mul(ks[0], s_in), "wk": mul(ks[1], s_in),
                "wv": mul(ks[2], s_in),
                "wo": mul(ks[3], 1.0 / math.sqrt(H * hd))}

    def mlp(k, ff: int, act: str) -> Dict:            # layers.mlp_init
        ks = prng.split(k, 3)
        names = ("gate", "up", "down") if act in ("swiglu", "geglu") \
            else ("up", "down")
        return {f"{n}/w": mul(ks[i], 1.0 / math.sqrt(ff if n == "down"
                                                     else d))
                for i, n in enumerate(names)}

    def mla(k) -> Dict:                               # mla.mla_init
        m = cfg.mla
        ks = prng.split(k, 8)
        out = {}
        if m.q_lora_rank:
            out["wdq"] = mul(ks[0], s_in)
            out["wuq"] = div(ks[1], m.q_lora_rank)
        else:
            out["wq"] = mul(ks[1], s_in)
        out.update(wdkv=mul(ks[2], s_in), wkr=mul(ks[3], s_in),
                   wuk=div(ks[4], m.kv_lora_rank),
                   wuv=div(ks[5], m.kv_lora_rank),
                   wo=div(ks[6], H * m.v_head_dim))
        return out

    def mamba2(k) -> Dict:                            # ssm.mamba2_init
        ks = prng.split(k, 8)
        out = {n: mul(ks[i], s_in) for i, n in enumerate(
            ("w_gate", "w_x", "w_b", "w_c", "w_dt"))}
        out.update({n: mul(ks[5 + i], 0.2) for i, n in enumerate(
            ("conv_x_w", "conv_b_w", "conv_c_w"))})
        out["out_proj"] = div(prng.fold_in(k, 99), cfg.ssm.d_inner)
        return out

    def rglru(k) -> Dict:                             # rglru.rglru_block_init
        W = cfg.rglru.width
        blk = W // rglru_mod.N_GATE_BLOCKS
        ks = prng.split(k, 6)
        return {"wx": mul(ks[0], s_in), "wy": mul(ks[1], s_in),
                "conv_w": mul(ks[2], 0.2),
                "gate_a": mul(ks[3], 1.0 / math.sqrt(blk)),
                "gate_i": mul(ks[4], 1.0 / math.sqrt(blk)),
                "out": div(ks[5], W)}

    def moe(k) -> Dict:                               # moe.moe_init
        ks = prng.split(k, 5)
        s_out = 1.0 / math.sqrt(cfg.d_ff)
        out = {"router": mul(ks[0], s_in), "gate_w": mul(ks[1], s_in),
               "up_w": mul(ks[2], s_in), "down_w": mul(ks[3], s_out)}
        if cfg.moe.n_shared:
            out.update({f"shared/{n}": v for n, v in mlp(
                ks[4], cfg.moe.n_shared * cfg.d_ff, "swiglu").items()})
        return out

    mixers = {"gqa": gqa, "local": gqa, "mla": mla, "ssd": mamba2,
              "rglru": rglru}

    def layer(k, spec: LayerSpec) -> Dict:            # _layer_init
        ks = prng.split(k, 6)
        out = {f"mixer/{n}": v for n, v in mixers[spec.mixer](ks[0]).items()}
        if spec.cross:
            out.update({f"cross/{n}": v for n, v in gqa(ks[1]).items()})
        if spec.ffn == "dense":
            ffn = mlp(ks[2], spec.d_ff or cfg.d_ff, cfg.act)
        elif spec.ffn == "moe":
            ffn = moe(ks[2])
        else:
            ffn = {}
        out.update({f"ffn/{n}": v for n, v in ffn.items()})
        return out

    def encoder_layer(k) -> Dict:                     # _encoder_layer_init
        ks = prng.split(k, 3)
        out = {f"mixer/{n}": v for n, v in gqa(ks[0]).items()}
        out.update({f"ffn/{n}": v for n, v in mlp(ks[1], cfg.d_ff,
                                                  cfg.act).items()})
        return out

    def stacked(prefix: str, per_repeat: list) -> Dict[str, Draw]:
        return {f"{prefix}/{n}": ([r[n][0] for r in per_repeat], scale, dv)
                for n, (_, scale, dv) in per_repeat[0].items()}

    keys = prng.split(prng.key(seed), len(plan) + 4)
    out: Dict[str, Draw] = {"embed/table": ([keys[0]], 0.02, False)}
    if not cfg.tie_embeddings:
        out["lm_head/w"] = ([keys[1]], 0.02, False)
    if cfg.encoder is not None:
        lk = prng.split(prng.split(keys[2], 2)[0], cfg.encoder.n_layers)
        out.update(stacked("encoder/layers", [encoder_layer(k) for k in lk]))
    for si, stage in enumerate(plan):
        for ui, spec in enumerate(stage.unit):
            lk = prng.split(prng.fold_in(keys[3 + si], ui), stage.repeats)
            out.update(stacked(f"stage{si}/u{ui}",
                               [layer(k, spec) for k in lk]))
    return out


def init(cfg: ArchConfig, *, seed: int = 0, device=None,
         dtype: torch.dtype = DEFAULT_COMPUTE_DTYPE,
         stacked: bool = False) -> Dict:
    """The JAX package's ``lm.init(cfg, PRNGKey(seed))`` on ``device``:
    every random leaf is drawn from the reference's threefry key
    (:func:`draw_keys`) by :func:`repro_torch.kernels.threefry.draw` (the
    CUDA kernel on the card, the plain version on the CPU), in the
    reference's shape and order, scaled as the reference scales it and
    stored in the leaf's dtype (``bridge.leaf_dtype``).  A stacked leaf is
    drawn one repeat at a time, straight into its slice.  ``stacked``
    keeps stage units as stacked leaves, for training
    (``params_from_numpy``)."""
    from .bridge import leaf_dtype, params_from_numpy

    device = resolve_device(device)
    draws = draw_keys(cfg, seed)
    flat = {}
    for key, (shape, how) in param_shapes(cfg).items():
        if isinstance(how, str):
            flat[key] = _fixed_init(how, shape[-1]).to(device).expand(
                shape).clone()
            continue
        t = torch.empty(shape, dtype=leaf_dtype(key, dtype), device=device)
        keys, scale, divide = draws[key]
        stacked_leaf = key.startswith(("stage", "encoder/layers"))
        parts = list(t) if stacked_leaf else [t]
        if len(parts) != len(keys):
            raise AssertionError(f"{key}: {len(parts)} parts, {len(keys)} "
                                 f"keys")
        for part, k in zip(parts, keys):
            threefry.draw(part, k, "normal", scale=scale, divide=divide)
        flat[key] = t
    return params_from_numpy(cfg, flat, device=device, dtype=dtype,
                             stacked=stacked)


# ================================================================ layers
def _unbind(tree: Dict, reps: int) -> list:
    """Per-layer views of a unit's stacked leaves, one ``unbind`` a leaf:
    its backward stacks the layers' gradients into one tensor (a
    ``select`` per layer would allocate a whole zero gradient each)."""
    layers = [{} for _ in range(reps)]
    for key, val in tree.items():
        parts = _unbind(val, reps) if isinstance(val, dict) \
            else val.unbind(0)
        for r in range(reps):
            layers[r][key] = parts[r]
    return layers


def _per_layer(unit, reps: int) -> list:
    """A unit's per-layer dicts: as given (serving) or views of its
    stacked leaves (training)."""
    return unit if isinstance(unit, list) else _unbind(unit, reps)


def _layers(cfg: ArchConfig, params: Dict):
    """(spec, stage key, unit key, repeat, repeats, layer params) in
    execution order: stage after stage, each repeat of the stage's unit in
    turn.  A unit is a list of per-layer dicts (serving) or a dict of
    stacked leaves (training)."""
    for si, stage in enumerate(build_plan(cfg)):
        units = [_per_layer(params[f"stage{si}"][f"u{ui}"], stage.repeats)
                 for ui in range(len(stage.unit))]
        for r in range(stage.repeats):
            for ui, spec in enumerate(stage.unit):
                yield (spec, f"stage{si}", f"u{ui}", r, stage.repeats,
                       units[ui][r])


def _window(cfg: ArchConfig, spec: LayerSpec) -> int:
    return cfg.rglru.window if spec.mixer == "local" and cfg.rglru else 0


def _head(cfg: ArchConfig, params: Dict, x: torch.Tensor, dtype):
    if cfg.tie_embeddings:
        return unembed(params["embed"], x, dtype)
    return mm(x, cast(params["lm_head"]["w"], dtype))


def _ffn(cfg: ArchConfig, spec: LayerSpec, p: Dict, x: torch.Tensor,
         dtype, shard=NULL_SHARDER
         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The layer's dense or MoE FFN on ``x`` [B, S, D]: (out, the MoE's
    aux load-balance loss, None for a dense FFN)."""
    h = apply_norm(p["norm2"], x, cfg.norm)
    if spec.ffn == "moe":
        return moe_mod.moe_apply(p["ffn"], h, cfg.moe, shard=shard,
                                 dtype=dtype)
    B = x.shape[0]
    return apply_mlp(p["ffn"], h, cfg.act, dtype,
                     whook=lambda w: shard.weight_for_batch(w, B)), None


def _mix(cfg: ArchConfig, spec: LayerSpec, p: Dict, h: torch.Tensor,
         positions: torch.Tensor, backend: str, dtype,
         shard=NULL_SHARDER) -> Tuple:
    """The layer's mixer on the whole sequence ``h`` (normed): (out, the
    cache entry or recurrent state it leaves)."""
    if spec.mixer in ("gqa", "local"):
        window = _window(cfg, spec)
        return attn.gqa_apply(
            p["mixer"], h,
            rope_theta=cfg.rope_theta if cfg.has_attention else None,
            mask_kind="window" if window else "causal", window=window,
            positions=positions, backend=backend, shard=shard, dtype=dtype)
    if spec.mixer == "mla":
        return mla_mod.mla_apply(p["mixer"], h, cfg.mla,
                                 rope_theta=cfg.rope_theta,
                                 positions=positions, backend=backend,
                                 shard=shard, dtype=dtype)
    if spec.mixer == "ssd":
        return ssm_mod.mamba2_apply(p["mixer"], h, cfg.ssm, backend=backend,
                                    shard=shard, dtype=dtype)
    return rglru_mod.rglru_block_apply(p["mixer"], h, cfg.rglru,
                                       backend=backend, shard=shard,
                                       dtype=dtype)


def _cross(cfg: ArchConfig, p: Dict, x: torch.Tensor, enc_kv: Dict,
           backend: str, dtype, shard=NULL_SHARDER) -> torch.Tensor:
    """``x`` plus the layer's cross attention over the encoder's keys and
    values (``repro.models.lm._apply_layer``'s cross branch)."""
    h = apply_norm(p["norm_cross"], x, cfg.norm)
    return x + attn.cross_apply(p["cross"], h, enc_kv, backend=backend,
                                shard=shard, dtype=dtype)


def _layer(cfg: ArchConfig, spec: LayerSpec, p: Dict, x: torch.Tensor,
           enc_out, positions: torch.Tensor, backend: str, dtype,
           shard=NULL_SHARDER) -> Tuple:
    """One layer on the whole sequence (``repro.models.lm._apply_layer``):
    (x, the mixer's cache entry or state, the encoder's keys and values
    where it cross-attends else None, the MoE aux loss or None)."""
    h = apply_norm(p["norm1"], x, cfg.norm)
    mix, entry = _mix(cfg, spec, p, h, positions, backend, dtype, shard)
    x = x + mix
    enc_kv = None
    if spec.cross and enc_out is not None:
        enc_kv = attn.cross_kv(p["cross"], enc_out, dtype)
        x = _cross(cfg, p, x, enc_kv, backend, dtype, shard)
    aux = None
    if spec.ffn != "none":
        y, aux = _ffn(cfg, spec, p, x, dtype, shard)
        x = x + y
    return shard.activations(x), entry, enc_kv, aux


def _inputs(params: Dict, tokens: torch.Tensor,
            patches: Optional[torch.Tensor], dtype) -> torch.Tensor:
    """The token embeddings, with the patch embeddings [B, P, D] in front
    of them if given: [B, P + S, D]."""
    x = embed(params["embed"], tokens, dtype)
    if patches is None:
        return x
    return torch.cat([patches.to(dtype), x], dim=1)


# =============================================================== encoder
def _sinusoid(n: int, d: int, device) -> torch.Tensor:
    """Sinusoidal positions [n, d] in float32 (``repro.models.lm.
    _sinusoid``): sines of the first d/2 frequencies, then cosines."""
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    angle = pos / torch.pow(10_000.0, 2 * dim / d)
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)


def encoder_unit(cfg: ArchConfig, p: Dict, x: torch.Tensor, *,
                 backend: str = "kernel", shard=NULL_SHARDER,
                 dtype: torch.dtype = DEFAULT_COMPUTE_DTYPE) -> torch.Tensor:
    """One encoder layer: biased GQA with no rope and no mask, then the
    MLP, each behind a norm and a residual add."""
    h = apply_norm(p["norm1"], x, cfg.norm)
    mix, _ = attn.gqa_apply(p["mixer"], h, rope_theta=None,
                            mask_kind="none", backend=backend, shard=shard,
                            dtype=dtype)
    x = x + mix
    h = apply_norm(p["norm2"], x, cfg.norm)
    return shard.activations(x + apply_mlp(p["ffn"], h, cfg.act, dtype))


def _encode(cfg: ArchConfig, params: Dict, frames: torch.Tensor, *,
            remat: bool = False, backend: str = "kernel", shard=NULL_SHARDER,
            dtype: torch.dtype = DEFAULT_COMPUTE_DTYPE) -> torch.Tensor:
    """The whisper-style encoder over precomputed frame embeddings [B, F,
    D]: sinusoidal positions added in the compute dtype, every encoder
    layer (each recomputed in the backward with ``remat``), the final
    norm."""
    x = frames.to(dtype) + _sinusoid(frames.shape[1], cfg.d_model,
                                     frames.device).to(dtype)
    x = shard.activations(x)
    enc = params["encoder"]
    for p in _per_layer(enc["layers"], cfg.encoder.n_layers):
        if remat:
            x = checkpoint(encoder_unit, cfg, p, x, backend=backend,
                           shard=shard, dtype=dtype, use_reentrant=False)
        else:
            x = encoder_unit(cfg, p, x, backend=backend, shard=shard,
                             dtype=dtype)
    return apply_norm(enc["final_norm"], x, cfg.norm)


def _store(unit_c: Dict, entry: Dict, r: int, reps: int,
           slots: Optional[int] = None, shard=NULL_SHARDER,
           path: str = "") -> None:
    """Write one layer's cache ``entry`` at repeat ``r`` of its unit's
    stacked ``[reps, ...]`` leaves (allocated at first use).  With
    ``slots``, axis 1 of every leaf (the sequence) is zero-padded to that
    many slots.  Under a mesh the leaves are DTensors placed by
    ``specs.cache_spec`` (``path`` is the unit's path in the cache tree)
    and each rank writes its shard."""
    for name, t in entry.items():
        if name not in unit_c:
            shape = list(t.shape)
            if slots is not None:
                shape[1] = slots
            unit_c[name] = _zeros(shard, f"{path}/{name}", [reps] + shape, t)
        if shard.mesh is not None:
            calls.store(shard, unit_c[name], r, t, slots=slots is not None)
        elif slots is None:
            unit_c[name][r] = t
        else:
            unit_c[name][r, :, :t.shape[1]] = t


def _zeros(shard, path: str, shape: list, like: torch.Tensor):
    """A zero cache leaf: a plain tensor, or under a mesh a DTensor placed
    by ``specs.cache_spec``."""
    if shard.mesh is None:
        return like.new_zeros(shape)
    import torch.distributed.tensor as dt

    return dt.zeros(shape, dtype=like.dtype, device_mesh=shard.mesh,
                    placements=placements(cache_spec(path, tuple(shape),
                                                     shard.mesh),
                                          shard.mesh))


def _check_window(cfg: ArchConfig, max_seq: int) -> None:
    for stage in build_plan(cfg):
        for spec in stage.unit:
            if spec.mixer == "local" and max_seq > _window(cfg, spec):
                raise ValueError(
                    f"{cfg.arch_id}: max_seq={max_seq} exceeds the local "
                    f"attention window {_window(cfg, spec)}; the window's "
                    f"cache has no slot past it")


def prefill(cfg: ArchConfig, params: Dict, tokens: torch.Tensor, *,
            max_seq: int, patches: Optional[torch.Tensor] = None,
            enc_frames: Optional[torch.Tensor] = None,
            backend: str = "kernel", shard=NULL_SHARDER,
            dtype: torch.dtype = DEFAULT_COMPUTE_DTYPE):
    """Run the prompt, return (last-token logits [B,V], caches).

    ``patches`` ([B, P, D] embeddings) are prepended to the tokens and
    count against ``max_seq``; the next decode step's length is then P +
    S.  With ``enc_frames`` ([B, F, D] embeddings) and an encoder, the
    encoder runs once and each cross-attention layer caches its keys and
    values of the encoder's output; without them (or without an encoder)
    the cross layers are skipped, here and in every decode step, as in
    the JAX package.

    A local-attention layer's cache has exactly ``window`` slots, and the
    decode step writes a token at slot ``length`` (``repro.models.
    attention.gqa_decode`` takes the ring branch only when the cache is
    longer than the window), so a sequence may not outgrow the window:
    ``max_seq > window`` raises ``ValueError`` for a config with local
    layers.
    """
    S = tokens.shape[1] + (patches.shape[1] if patches is not None else 0)
    if max_seq < S:
        raise ValueError(
            f"max_seq={max_seq} smaller than prompt length {S} (includes "
            f"patch prefix)")
    _check_window(cfg, max_seq)
    x = shard.activations(_inputs(params, tokens, patches, dtype))
    positions = torch.arange(S, device=tokens.device)
    enc_out = None
    if cfg.encoder is not None and enc_frames is not None:
        enc_out = _encode(cfg, params, enc_frames, backend=backend,
                          shard=shard, dtype=dtype)
    caches: Dict = {}
    for spec, sk, uk, r, reps, p in _layers(cfg, params):
        unit_c = caches.setdefault(sk, {}).setdefault(uk, {})
        x, entry, enc_kv, _ = _layer(cfg, spec, p, x, enc_out, positions,
                                     backend, dtype, shard)
        slots = None
        if spec.mixer in ("gqa", "local"):
            # S <= max_seq <= window: the JAX package's ring of `window`
            # slots holds position t at slot t, as the padded cache does
            slots = _window(cfg, spec) or max_seq
        elif spec.mixer == "mla":
            slots = max_seq
        _store(unit_c, entry, r, reps, slots, shard, f"{sk}/{uk}")
        if enc_kv is not None:
            _store(unit_c.setdefault("cross", {}), enc_kv, r, reps,
                   shard=shard, path=f"{sk}/{uk}/cross")
    # the head is applied to the last position only, as in the JAX package
    last = apply_norm(params["final_norm"], x[:, -1, :], cfg.norm)
    return _head(cfg, params, last, dtype), caches


def _decode_layer(cfg: ArchConfig, spec: LayerSpec, p: Dict, c: Dict,
                  x: torch.Tensor, lengths: torch.Tensor, backend: str,
                  dtype, shard=NULL_SHARDER) -> torch.Tensor:
    """One layer of a decode step on [B, D]; ``c`` holds the layer's cache
    entries (views of the stacked leaves), updated in place."""
    h = apply_norm(p["norm1"], x, cfg.norm)
    if spec.mixer in ("gqa", "local"):
        mix, _ = attn.gqa_decode(
            p["mixer"], h, {"k": c["k"], "v": c["v"]}, lengths,
            rope_theta=cfg.rope_theta, window=_window(cfg, spec),
            backend=backend, shard=shard, dtype=dtype)
    elif spec.mixer == "mla":
        mix, _ = mla_mod.mla_decode(
            p["mixer"], h, {"c_kv": c["c_kv"], "k_rope": c["k_rope"]},
            lengths, cfg.mla, rope_theta=cfg.rope_theta, shard=shard,
            dtype=dtype)
    else:
        state = {name: t for name, t in c.items() if name != "cross"}
        if spec.mixer == "ssd":
            mix, new = ssm_mod.mamba2_decode(p["mixer"], h, state, cfg.ssm,
                                             shard=shard, dtype=dtype)
        else:
            mix, new = rglru_mod.rglru_block_decode(
                p["mixer"], h, state, cfg.rglru, shard=shard, dtype=dtype)
        for name, t in new.items():
            if shard.mesh is not None:
                t = t.redistribute(state[name].device_mesh,
                                   state[name].placements)
            state[name].copy_(t)
    x = x + mix
    if spec.cross and "cross" in c:
        x = _cross(cfg, p, x[:, None, :], c["cross"], backend, dtype,
                   shard)[:, 0]
    if spec.ffn != "none":
        # one token a row: the MoE dispatches it as a sequence of one
        x = x + _ffn(cfg, spec, p, x[:, None, :], dtype, shard)[0][:, 0]
    return x


def _repeat(c, r: int):
    """Repeat ``r``'s views of a unit's stacked cache leaves."""
    return {name: (_repeat(t, r) if isinstance(t, dict) else t[r])
            for name, t in c.items()}


def decode_step(cfg: ArchConfig, params: Dict, token: torch.Tensor,
                caches: Dict, lengths: torch.Tensor, *,
                backend: str = "kernel", shard=NULL_SHARDER,
                dtype: torch.dtype = DEFAULT_COMPUTE_DTYPE):
    """One token for every sequence in the batch: (logits [B,V], caches).

    ``caches`` is updated in place (the JAX package returns new ones) and
    returned; ``lengths`` (int32 ``[B]``) counts the positions cached.  A
    cross-attention layer attends to the encoder's keys and values that
    the prefill cached, where it cached them.
    """
    x = shard.decode_activations(embed(params["embed"], token, dtype))
    for spec, sk, uk, r, _, p in _layers(cfg, params):
        x = _decode_layer(cfg, spec, p, _repeat(caches[sk][uk], r), x,
                          lengths, backend, dtype, shard)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    return _head(cfg, params, x, dtype), caches


# ============================================================ unit probes
def _cache_entry(cfg: ArchConfig, spec: LayerSpec, entry: Dict,
                 max_seq: Optional[int]) -> Dict:
    """A layer's cache entry as the reference's ``_ring_or_pad_kv`` /
    ``_pad_mla`` leave it: none without ``max_seq``; attention keys and
    values padded to ``max_seq`` slots, or a local layer's last ``window``
    positions in their ring slots; MLA's latent and rope key padded."""
    if spec.mixer not in ("gqa", "local", "mla"):
        return entry
    if max_seq is None:
        return {}
    out = {}
    for name, a in entry.items():
        S, W = a.shape[1], _window(cfg, spec)
        if W:
            n = min(S, W)
            a = a[:, S - n:]
            if n < W:
                a = torch.cat([a, a.new_zeros((a.shape[0], W - n)
                                              + tuple(a.shape[2:]))], 1)
            out[name] = torch.roll(a, shifts=S % W if S > W else 0, dims=1)
        elif max_seq > S:
            out[name] = torch.cat([a, a.new_zeros(
                (a.shape[0], max_seq - S) + tuple(a.shape[2:]))], 1)
        else:
            out[name] = a
    return out


def apply_unit(cfg: ArchConfig, stage: Stage, repeat_p: Dict,
               x: torch.Tensor, *, enc_out=None, positions=None,
               max_seq: Optional[int] = None, backend: str = "kernel",
               shard=NULL_SHARDER,
               dtype: torch.dtype = DEFAULT_COMPUTE_DTYPE) -> Tuple:
    """One repeat of a stage's unit (``repro.models.lm.apply_unit``, the
    reference's scan body): (x, cache entries by unit key, aux)."""
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)
    entries: Dict = {}
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for ui, spec in enumerate(stage.unit):
        x, entry, enc_kv, a = _layer(cfg, spec, repeat_p[f"u{ui}"], x,
                                     enc_out, positions, backend, dtype,
                                     shard)
        entries[f"u{ui}"] = _cache_entry(cfg, spec, entry, max_seq)
        if enc_kv is not None:
            entries[f"u{ui}"]["cross"] = enc_kv
        if a is not None:
            aux = aux + a
    return x, entries, aux


def decode_unit(cfg: ArchConfig, stage: Stage, repeat_p: Dict,
                repeat_c: Dict, x: torch.Tensor, lengths: torch.Tensor, *,
                backend: str = "kernel", shard=NULL_SHARDER,
                dtype: torch.dtype = DEFAULT_COMPUTE_DTYPE) -> Tuple:
    """One repeat of a stage's unit in decode mode (``repro.models.lm.
    decode_unit``): (x, the unit's cache entries, updated in place)."""
    for ui, spec in enumerate(stage.unit):
        x = _decode_layer(cfg, spec, repeat_p[f"u{ui}"], repeat_c[f"u{ui}"],
                          x, lengths, backend, dtype, shard)
    return x, repeat_c


# =============================================================== training
def forward(cfg: ArchConfig, params: Dict, tokens: torch.Tensor, *,
            patches: Optional[torch.Tensor] = None,
            enc_frames: Optional[torch.Tensor] = None,
            return_hidden: bool = False, remat: bool = False,
            backend: str = "kernel", shard=NULL_SHARDER,
            dtype: torch.dtype = DEFAULT_COMPUTE_DTYPE) -> Tuple:
    """The whole sequence, no cache (``repro.models.lm.forward``): (logits
    [B,S,V] -- or the final hidden states [B,S,D] if ``return_hidden``,
    for the vocab-chunked loss -- , the summed MoE aux loss).  ``patches``
    [B, P, D] are prepended to the tokens (S counts them); with
    ``enc_frames`` [B, F, D] and an encoder, the encoder runs once and
    each cross-attention layer attends to its output.

    ``remat`` recomputes each layer, the encoder's too, in the backward
    (``torch.utils.checkpoint``, the counterpart of ``jax.checkpoint`` on
    the reference's scan body; here per layer, not per unit).
    """
    x = shard.activations(_inputs(params, tokens, patches, dtype))
    positions = torch.arange(x.shape[1], device=tokens.device)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    enc_out = None
    if cfg.encoder is not None and enc_frames is not None:
        enc_out = _encode(cfg, params, enc_frames, remat=remat,
                          backend=backend, shard=shard, dtype=dtype)

    def layer(spec, p, x, enc_out):
        x, _, _, a = _layer(cfg, spec, p, x, enc_out, positions, backend,
                            dtype, shard)
        return x, a

    for spec, _, _, _, _, p in _layers(cfg, params):
        if remat:
            x, a = checkpoint(layer, spec, p, x, enc_out, use_reentrant=False)
        else:
            x, a = layer(spec, p, x, enc_out)
        if a is not None:
            aux = aux + a
    x = apply_norm(params["final_norm"], x, cfg.norm)
    if return_hidden:
        return x, aux
    return shard.logits(_head(cfg, params, x, dtype)), aux


def _nll_chunk(x, table, transpose: bool, targets, vocab: int, start: int,
               chunk: int, m, se, tl, dtype):
    """One vocabulary chunk of :func:`_chunked_nll`: its logits, then the
    running max ``m``, sum of exponentials ``se`` and target logit
    ``tl``.  Under a mesh each rank's logits hold whole rows (the chunk's
    columns unsharded) for the target's gather."""
    if transpose:
        logits = mm(x, cast(table[start:start + chunk], dtype).T,
                    shard_out=False)
    else:
        logits = mm(x, cast(table[:, start:start + chunk], dtype),
                    shard_out=False)
    logits = logits.float()
    width = logits.shape[-1]
    cols = start + torch.arange(width, device=x.device)
    logits = torch.where(cols < vocab, logits, logits.new_full((), -1e30))
    new_m = torch.maximum(m, logits.amax(-1))
    se = se * torch.exp(m - new_m) + torch.exp(
        logits - new_m[..., None]).sum(-1)
    local = targets - start
    in_range = (local >= 0) & (local < width)
    lt = logits.gather(-1, local.clamp(0, width - 1)[..., None])[..., 0]
    return new_m, se, torch.where(in_range, lt, tl)


def _chunked_nll(x: torch.Tensor, table: torch.Tensor, transpose: bool,
                 targets: torch.Tensor, vocab: int, chunk: int = 8192,
                 dtype: torch.dtype = DEFAULT_COMPUTE_DTYPE) -> Tuple:
    """Online-logsumexp cross entropy over vocabulary chunks
    (``repro.models.lm._chunked_nll``): the head's product streams over
    chunks of ``chunk`` columns, so the fp32 logits transient is [B, S,
    chunk], and under autograd each chunk is recomputed in the backward
    (``torch.utils.checkpoint``, as the reference checkpoints its scan
    body).  ``table`` is [V, D] if ``transpose`` (tied embeddings) else
    [D, V]; columns ``>= vocab`` get -1e30.  Returns (nll [B,S], lse
    [B,S]).

    The last chunk is cut at V.  The reference's ``dynamic_slice`` instead
    moves a last chunk that would run past V back inside it while its
    column labels stay where they were, so when ``chunk`` does not divide
    V its loss counts some columns twice, misses others and reads targets
    in the last chunk from the wrong column (``ROADMAP.md`` C); the two
    agree exactly when ``chunk`` divides V or is at least V.
    """
    B, S, _ = x.shape
    V = table.shape[0] if transpose else table.shape[1]
    chunk = min(chunk, V)
    m = torch.full((B, S), -1e30, dtype=torch.float32, device=x.device)
    se = torch.zeros((B, S), dtype=torch.float32, device=x.device)
    tl = torch.zeros((B, S), dtype=torch.float32, device=x.device)
    grad = torch.is_grad_enabled() and (x.requires_grad
                                        or table.requires_grad)
    for start in range(0, V, chunk):
        args = (x, table, transpose, targets, vocab, start, chunk, m, se, tl,
                dtype)
        m, se, tl = checkpoint(_nll_chunk, *args, use_reentrant=False) \
            if grad else _nll_chunk(*args)
    lse = torch.log(torch.clamp(se, min=1e-30)) + m
    return lse - tl, lse


def loss_fn(cfg: ArchConfig, params: Dict, batch: Dict, *,
            backend: str = "kernel", shard=NULL_SHARDER, remat: bool = False,
            aux_coef: float = 0.01, z_coef: float = 1e-4,
            dtype: torch.dtype = DEFAULT_COMPUTE_DTYPE
            ) -> Tuple[torch.Tensor, Dict]:
    """Next-token cross entropy (+ MoE aux + z-loss), vocab-chunked
    (``repro.models.lm.loss_fn``): (total, {"nll", "aux", "z"}).  The
    batch's ``patches`` and ``frames``, where it has them, go to
    :func:`forward`; the loss is taken on the token positions only."""
    tokens, patches = batch["tokens"], batch.get("patches")
    hidden, aux = forward(cfg, params, tokens, patches=patches,
                          enc_frames=batch.get("frames"), return_hidden=True,
                          remat=remat, backend=backend, shard=shard,
                          dtype=dtype)
    n_prefix = 0 if patches is None else patches.shape[1]
    x = hidden[:, n_prefix:-1, :]
    targets = tokens[:, 1:]
    if cfg.tie_embeddings:
        nll, lse = _chunked_nll(x, params["embed"]["table"], True, targets,
                                cfg.padded_vocab, dtype=dtype)
    else:
        nll, lse = _chunked_nll(x, params["lm_head"]["w"], False, targets,
                                cfg.padded_vocab, dtype=dtype)
    nll = nll.mean()
    z_loss = z_coef * torch.square(lse).mean()
    total = nll + z_loss + aux_coef * aux
    return total, {"nll": nll, "aux": aux, "z": z_loss}
