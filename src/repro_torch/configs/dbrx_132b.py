"""dbrx-132b — fine-grained MoE, 16 experts top-4
[hf:databricks/dbrx-base; unverified].

40L d_model=6144 48H (GQA kv=8) d_ff=10752 (per expert) vocab=100352.
"""
from .base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    arch_id="dbrx-132b",
    family="moe",
    vocab_size=100352,
    d_model=6144,
    n_layers=40,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,
    head_dim=128,
    rope_theta=500_000.0,
    moe=MoEConfig(n_experts=16, top_k=4),
    source="hf:databricks/dbrx-base",
)
