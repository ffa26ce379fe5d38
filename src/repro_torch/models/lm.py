"""The language model of the port (``repro.models.lm``), dense GQA plan.

``build_plan`` is the JAX package's; the port runs the plan
``Stage((LayerSpec("gqa", "dense"),), n_layers)``: yi-6b, yi-34b,
mistral-nemo and pixtral's text path.  The JAX package scans each stage's
stacked parameters with ``lax.scan``; here the stacked parameters are
split into a list of per-layer views when they are loaded
(:mod:`repro_torch.models.bridge`) and a Python loop walks them.

Parameters are a nested dict: ``params["stage0"]["u0"]`` is the list of
per-layer dicts of stage 0's unit 0, other leaves are as in the JAX
package (``params["embed"]["table"]`` and so on).  KV caches are
``caches["stage0"]["u0"] = {"k": [L, B, max_seq, KV, hd], "v": ...}``,
updated in place by :func:`decode_step`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union

import torch

from .. import resolve_device
from ..configs.base import ArchConfig
from . import attention as attn
from .layers import (
    DEFAULT_COMPUTE_DTYPE,
    apply_mlp,
    apply_norm,
    cast,
    embed,
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


_LATER = {
    "mla": "the MLA mixer (minicpm3-4b, deepseek-v2-lite) comes with the "
           "MLA slice",
    "ssd": "the Mamba-2 SSD mixer (mamba2-2.7b) comes with the Mamba-2 slice",
    "rglru": "the RG-LRU mixer (recurrentgemma-2b) comes with the RG-LRU "
             "slice",
    "local": "local attention with a ring cache (recurrentgemma-2b) comes "
             "with the RG-LRU slice",
    "moe": "the MoE FFN (dbrx, deepseek-v2-lite) comes with the MoE slice",
    "cross": "the encoder and cross attention (whisper) come with the "
             "encoder-decoder slice",
}


def dense_plan(cfg: ArchConfig) -> Tuple[Stage, ...]:
    """The plan, if this slice of the port runs it; else NotImplementedError."""
    plan = build_plan(cfg)
    for stage in plan:
        for spec in stage.unit:
            for part in (spec.mixer, spec.ffn, "cross" if spec.cross else ""):
                if part in _LATER:
                    raise NotImplementedError(
                        f"{cfg.arch_id}: not ported yet: {_LATER[part]}")
    return plan


# ================================================================== init
Init = Union[float, str]        # normal std, or "ones" / "zeros"


def param_shapes(cfg: ArchConfig) -> Dict[str, Tuple[Tuple[int, ...], Init]]:
    """Every parameter by its flat path (the JAX package's pytree path,
    ``stage0/u0/mixer/wq``), with its shape and its initialisation as in
    ``repro.models.lm.init``.  Stage parameters carry the leading
    ``[repeats]`` axis, as they do there."""
    plan = dense_plan(cfg)
    d, V = cfg.d_model, cfg.padded_vocab
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    bias = cfg.norm == "layer"

    def norm(prefix: str, lead: Tuple[int, ...]) -> Dict:
        out = {f"{prefix}/scale": (lead + (d,), "ones")}
        if bias:
            out[f"{prefix}/bias"] = (lead + (d,), "zeros")
        return out

    shapes: Dict[str, Tuple[Tuple[int, ...], Init]] = {
        "embed/table": ((V, d), 0.02)}
    shapes.update(norm("final_norm", ()))
    if not cfg.tie_embeddings:
        shapes["lm_head/w"] = ((d, V), 0.02)
    for si, stage in enumerate(plan):
        for ui, spec in enumerate(stage.unit):
            L = (stage.repeats,)
            pre = f"stage{si}/u{ui}"
            ff = spec.d_ff or cfg.d_ff
            shapes.update(norm(f"{pre}/norm1", L))
            s_in = 1.0 / math.sqrt(d)
            shapes[f"{pre}/mixer/wq"] = (L + (d, H, hd), s_in)
            shapes[f"{pre}/mixer/wk"] = (L + (d, KV, hd), s_in)
            shapes[f"{pre}/mixer/wv"] = (L + (d, KV, hd), s_in)
            shapes[f"{pre}/mixer/wo"] = (L + (H, hd, d),
                                         1.0 / math.sqrt(H * hd))
            if bias:
                shapes[f"{pre}/mixer/bq"] = (L + (H, hd), "zeros")
                shapes[f"{pre}/mixer/bk"] = (L + (KV, hd), "zeros")
                shapes[f"{pre}/mixer/bv"] = (L + (KV, hd), "zeros")
                shapes[f"{pre}/mixer/bo"] = (L + (d,), "zeros")
            shapes.update(norm(f"{pre}/norm2", L))
            if cfg.act in ("swiglu", "geglu"):
                shapes[f"{pre}/ffn/gate/w"] = (L + (d, ff), s_in)
                shapes[f"{pre}/ffn/up/w"] = (L + (d, ff), s_in)
                shapes[f"{pre}/ffn/down/w"] = (L + (ff, d),
                                               1.0 / math.sqrt(ff))
            else:
                shapes[f"{pre}/ffn/up/w"] = (L + (d, ff), s_in)
                shapes[f"{pre}/ffn/up/b"] = (L + (ff,), "zeros")
                shapes[f"{pre}/ffn/down/w"] = (L + (ff, d),
                                               1.0 / math.sqrt(ff))
                shapes[f"{pre}/ffn/down/b"] = (L + (d,), "zeros")
    return shapes


def init(cfg: ArchConfig, *, seed: int = 0, device=None,
         dtype: torch.dtype = DEFAULT_COMPUTE_DTYPE) -> Dict:
    """Random parameters with the JAX package's shapes and scales, drawn
    from a ``torch.Generator`` seeded with ``seed`` on ``device`` (so they
    are not the JAX package's numbers; tests share weights through
    :func:`repro_torch.models.bridge.params_from_numpy`)."""
    from .bridge import params_from_numpy

    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flat = {}
    for key, (shape, how) in param_shapes(cfg).items():
        if how == "ones":
            flat[key] = torch.ones(shape, device=device)
        elif how == "zeros":
            flat[key] = torch.zeros(shape, device=device)
        else:
            flat[key] = torch.randn(shape, generator=gen, device=device
                                    ).mul_(how).to(dtype)
    return params_from_numpy(cfg, flat, device=device, dtype=dtype)


# ================================================================ serving
def _layers(cfg: ArchConfig, params: Dict):
    """(stage key, unit key, repeat, layer params) in execution order."""
    for si, stage in enumerate(dense_plan(cfg)):
        for r in range(stage.repeats):
            for ui in range(len(stage.unit)):
                yield (f"stage{si}", f"u{ui}", r,
                       params[f"stage{si}"][f"u{ui}"][r])


def _head(cfg: ArchConfig, params: Dict, x: torch.Tensor, dtype):
    if cfg.tie_embeddings:
        return unembed(params["embed"], x, dtype)
    return x @ cast(params["lm_head"]["w"], dtype)


def prefill(cfg: ArchConfig, params: Dict, tokens: torch.Tensor, *,
            max_seq: int, backend: str = "kernel",
            dtype: torch.dtype = DEFAULT_COMPUTE_DTYPE):
    """Run the prompt, return (last-token logits [B,V], caches)."""
    B, S = tokens.shape
    if max_seq < S:
        raise ValueError(
            f"max_seq={max_seq} smaller than prompt length {S}")
    device = tokens.device
    KV, hd = cfg.n_kv_heads, cfg.head_dim_
    x = embed(params["embed"], tokens, dtype)
    positions = torch.arange(S, device=device)
    caches: Dict = {}
    for sk, uk, r, p in _layers(cfg, params):
        unit_c = caches.setdefault(sk, {})
        if uk not in unit_c:
            reps = len(params[sk][uk])
            unit_c[uk] = {
                "k": torch.zeros((reps, B, max_seq, KV, hd), dtype=dtype,
                                 device=device),
                "v": torch.zeros((reps, B, max_seq, KV, hd), dtype=dtype,
                                 device=device)}
        h = apply_norm(p["norm1"], x, cfg.norm)
        mix, kv = attn.gqa_apply(p["mixer"], h, rope_theta=cfg.rope_theta,
                                 mask_kind="causal", positions=positions,
                                 backend=backend, dtype=dtype)
        unit_c[uk]["k"][r, :, :S] = kv["k"]
        unit_c[uk]["v"][r, :, :S] = kv["v"]
        x = x + mix
        x = x + apply_mlp(p["ffn"], apply_norm(p["norm2"], x, cfg.norm),
                          cfg.act, dtype)
    # the head is applied to the last position only, as in the JAX package
    last = apply_norm(params["final_norm"], x[:, -1, :], cfg.norm)
    return _head(cfg, params, last, dtype), caches


def decode_step(cfg: ArchConfig, params: Dict, token: torch.Tensor,
                caches: Dict, lengths: torch.Tensor, *,
                backend: str = "kernel",
                dtype: torch.dtype = DEFAULT_COMPUTE_DTYPE):
    """One token for every sequence in the batch: (logits [B,V], caches).

    ``caches`` is updated in place (see :func:`attn.gqa_decode`) and
    returned; ``lengths`` (int32 ``[B]``) counts the positions cached.
    """
    x = embed(params["embed"], token, dtype)                  # [B,D]
    for sk, uk, r, p in _layers(cfg, params):
        c = caches[sk][uk]
        h = apply_norm(p["norm1"], x, cfg.norm)
        mix, _ = attn.gqa_decode(p["mixer"], h, {"k": c["k"][r], "v": c["v"][r]},
                                 lengths, rope_theta=cfg.rope_theta,
                                 backend=backend, dtype=dtype)
        x = x + mix
        x = x + apply_mlp(p["ffn"], apply_norm(p["norm2"], x, cfg.norm),
                          cfg.act, dtype)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    return _head(cfg, params, x, dtype), caches
