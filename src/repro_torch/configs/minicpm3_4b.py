"""minicpm3-4b — dense with MLA [hf:openbmb/MiniCPM3-4B; hf].

62L d_model=2560 40H (kv=40) d_ff=6400 vocab=73448; MLA q_lora=768,
kv_lora=256, qk_nope=64, qk_rope=32, v_head=64 (per released config).
"""
from .base import ArchConfig, MLAConfig

CONFIG = ArchConfig(
    arch_id="minicpm3-4b",
    family="dense",
    vocab_size=73448,
    d_model=2560,
    n_layers=62,
    n_heads=40,
    n_kv_heads=40,
    d_ff=6400,
    attn_kind="mla",
    rope_theta=10_000.0,
    mla=MLAConfig(kv_lora_rank=256, q_lora_rank=768,
                  qk_nope_dim=64, qk_rope_dim=32, v_head_dim=64),
    tie_embeddings=True,
    source="hf:openbmb/MiniCPM3-4B",
)
