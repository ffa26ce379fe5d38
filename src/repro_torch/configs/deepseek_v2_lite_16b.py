"""deepseek-v2-lite-16b — MLA + fine-grained MoE [arXiv:2405.04434; hf].

27L d_model=2048 16H d_ff=1408 (routed expert) vocab=102400, MLA
kv_lora=512, 2 shared + 64 routed experts top-6 (the assignment note lists
"64e top-6 ... 2 shared+160 routed"; 160 routed belongs to full V2 — V2-Lite
has 64 routed, so we follow the "64e" figure).  First layer keeps a dense
FFN (width 10944), as in the released model.
"""
from .base import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    arch_id="deepseek-v2-lite-16b",
    family="moe",
    vocab_size=102400,
    d_model=2048,
    n_layers=27,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    attn_kind="mla",
    rope_theta=10_000.0,
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=None,
                  qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128),
    moe=MoEConfig(n_experts=64, top_k=6, n_shared=2,
                  first_dense_layers=1, d_ff_dense=10944),
    source="arXiv:2405.04434",
)
