"""pixtral-12b — VLM: pixtral-ViT frontend (STUB) + mistral-nemo backbone
[hf:mistralai/Pixtral-12B-2409; unverified].

40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072, head_dim=128.
input_specs() supplies precomputed patch embeddings [B, n_patches, d_model]
prepended to the token embeddings; loss is computed on token positions only.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    arch_id="pixtral-12b",
    family="vlm",
    vocab_size=131072,
    d_model=5120,
    n_layers=40,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    head_dim=128,
    rope_theta=1_000_000.0,
    n_patches=1024,        # one 1024-patch image per sequence
    source="hf:mistralai/Pixtral-12B-2409",
)
