"""yi-6b — dense llama-arch GQA [arXiv:2403.04652; hf].

32L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    arch_id="yi-6b",
    family="dense",
    vocab_size=64000,
    d_model=4096,
    n_layers=32,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11008,
    rope_theta=5_000_000.0,
    source="arXiv:2403.04652",
)
