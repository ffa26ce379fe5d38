"""mistral-nemo-12b — dense GQA, 128k context
[hf:mistralai/Mistral-Nemo-Base-2407; hf].

40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072, head_dim=128
(not d_model/n_heads = 160).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    arch_id="mistral-nemo-12b",
    family="dense",
    vocab_size=131072,
    d_model=5120,
    n_layers=40,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    head_dim=128,
    rope_theta=1_000_000.0,
    source="hf:mistralai/Mistral-Nemo-Base-2407",
)
