"""Architecture configuration dataclasses.

One :class:`ArchConfig` fully describes a model in the zoo.  The assigned
architectures (see ``src/repro/configs/<id>.py``) instantiate it with their
published hyper-parameters; smoke tests use :func:`ArchConfig.reduced`.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

#: Pad vocabularies to a multiple of this so the vocab dim shards over the
#: 16-way model axis (standard practice for tensor-parallel embeddings).
VOCAB_PAD_MULTIPLE = 256


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    n_shared: int = 0             # shared (always-on) experts, DeepSeek-style
    capacity_factor: float = 1.25
    first_dense_layers: int = 0   # leading layers that keep a dense FFN
    d_ff_dense: Optional[int] = None  # FFN width of those dense layers


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2 / MiniCPM3)."""

    kv_lora_rank: int
    q_lora_rank: Optional[int] = None   # None => full-rank queries
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 SSD mixer."""

    d_inner: int
    head_dim: int = 64            # P
    state_dim: int = 128          # N
    n_groups: int = 1
    conv_width: int = 4
    chunk: int = 128              # SSD chunk length


@dataclass(frozen=True)
class RGLRUConfig:
    """RecurrentGemma recurrent block + local-attention hybrid."""

    width: int                    # RG-LRU channel count (lru_width)
    conv_width: int = 4
    window: int = 2048            # local attention window
    pattern: Tuple[str, ...] = ("rec", "rec", "attn")  # 1:2 attn:rec


@dataclass(frozen=True)
class EncoderConfig:
    """Encoder half of an encoder-decoder model (whisper)."""

    n_layers: int
    n_frames: int = 1536          # padded from whisper's 1500 for sharding


@dataclass(frozen=True)
class ArchConfig:
    arch_id: str
    family: str                   # dense|moe|ssm|hybrid|audio|vlm
    vocab_size: int
    d_model: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    head_dim: Optional[int] = None
    norm: str = "rms"             # rms|layer
    act: str = "swiglu"           # swiglu|geglu|gelu
    attn_kind: str = "gqa"        # gqa|mla|none
    rope_theta: float = 10_000.0
    mla: Optional[MLAConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    encoder: Optional[EncoderConfig] = None
    n_patches: int = 0            # VLM stub: precomputed patch embeddings
    tie_embeddings: bool = False
    sub_quadratic: bool = False   # eligible for long_500k
    source: str = ""              # provenance note

    # ------------------------------------------------------------- derived
    @property
    def head_dim_(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        m = VOCAB_PAD_MULTIPLE
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def has_attention(self) -> bool:
        return self.attn_kind != "none" or self.rglru is not None

    def n_params(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, v = self.d_model, self.padded_vocab
        total = v * d * (1 if self.tie_embeddings else 2)
        total += self.n_layers * self._params_per_layer()
        if self.encoder is not None:
            enc_layer = (4 * d * d  # self-attn (q,k,v,o at full width approx)
                         + 2 * d * self.d_ff + 4 * d)
            total += self.encoder.n_layers * enc_layer
        return total

    def n_active_params(self) -> int:
        """Parameters touched per token (MoE: only routed-active experts)."""
        if self.moe is None:
            return self.n_params()
        d, v = self.d_model, self.padded_vocab
        total = v * d * (1 if self.tie_embeddings else 2)
        per_layer_attn = self._attn_params()
        ff = 0
        mult = 3 if self.act in ("swiglu", "geglu") else 2
        active_experts = self.moe.top_k + self.moe.n_shared
        ff = active_experts * mult * d * self.d_ff + d * self.moe.n_experts
        total += self.n_layers * (per_layer_attn + ff)
        return total

    def _attn_params(self) -> int:
        d, hd = self.d_model, self.head_dim_
        if self.attn_kind == "mla":
            m = self.mla
            q_in = m.q_lora_rank if m.q_lora_rank else d
            p = d * (m.q_lora_rank or 0)
            p += q_in * self.n_heads * (m.qk_nope_dim + m.qk_rope_dim)
            p += d * (m.kv_lora_rank + m.qk_rope_dim)
            p += m.kv_lora_rank * self.n_heads * (m.qk_nope_dim + m.v_head_dim)
            p += self.n_heads * m.v_head_dim * d
            return p
        if self.attn_kind == "gqa":
            return d * hd * (self.n_heads + 2 * self.n_kv_heads) \
                + self.n_heads * hd * d
        if self.ssm is not None:
            s = self.ssm
            heads = s.d_inner // s.head_dim
            proj_in = d * (2 * s.d_inner
                           + 2 * s.n_groups * s.state_dim + heads)
            return proj_in + s.d_inner * d + heads
        return 0

    def _params_per_layer(self) -> int:
        d = self.d_model
        mult = 3 if self.act in ("swiglu", "geglu") else 2
        if self.ssm is not None:
            return self._attn_params() + 2 * d  # mamba2 has no separate FFN
        ff = mult * d * self.d_ff
        if self.moe is not None:
            ff = self.moe.n_experts * mult * d * self.d_ff \
                + d * self.moe.n_experts \
                + self.moe.n_shared * mult * d * self.d_ff
        attn = self._attn_params()
        if self.rglru is not None:
            r = self.rglru
            n_rec = sum(1 for p in r.pattern if p == "rec")
            n_att = len(r.pattern) - n_rec
            rec = d * r.width * 2 + r.width * d + 4 * r.width \
                + r.conv_width * r.width
            att = self._attn_params()
            attn = (n_rec * rec + n_att * att) / len(r.pattern)
        return int(attn + ff + 2 * d)

    # ------------------------------------------------------------- reduced
    def reduced(self, **overrides) -> "ArchConfig":
        """A tiny same-family config for CPU smoke tests."""
        def shrink(cfg):
            changes = dict(
                d_model=128,
                n_layers=max(2, min(4, self.n_layers // 16)),
                n_heads=4,
                n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
                d_ff=256,
                head_dim=32 if self.head_dim else None,
                vocab_size=512,
            )
            if cfg.moe:
                changes["moe"] = dataclasses.replace(
                    cfg.moe, n_experts=4, top_k=2,
                    n_shared=min(1, cfg.moe.n_shared),
                    first_dense_layers=min(1, cfg.moe.first_dense_layers),
                    d_ff_dense=256 if cfg.moe.d_ff_dense else None)
            if cfg.mla:
                changes["mla"] = MLAConfig(
                    kv_lora_rank=64,
                    q_lora_rank=64 if cfg.mla.q_lora_rank else None,
                    qk_nope_dim=32, qk_rope_dim=16, v_head_dim=32)
            if cfg.ssm:
                changes["ssm"] = SSMConfig(
                    d_inner=256, head_dim=32, state_dim=32,
                    n_groups=1, conv_width=4, chunk=16)
            if cfg.rglru:
                changes["rglru"] = dataclasses.replace(
                    cfg.rglru, width=128, window=64)
                changes["n_layers"] = 3  # one full (rec, rec, attn) pattern
            if cfg.encoder:
                changes["encoder"] = EncoderConfig(n_layers=2, n_frames=32)
            if cfg.n_patches:
                changes["n_patches"] = 8
            return changes

        base = shrink(self)
        base.update(overrides)
        return dataclasses.replace(self, **base)
