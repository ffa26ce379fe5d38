"""yi-34b — dense llama-arch GQA [arXiv:2403.04652; hf].

60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    arch_id="yi-34b",
    family="dense",
    vocab_size=64000,
    d_model=7168,
    n_layers=60,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    rope_theta=5_000_000.0,
    source="arXiv:2403.04652",
)
