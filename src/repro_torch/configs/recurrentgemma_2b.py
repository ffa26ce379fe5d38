"""recurrentgemma-2b — Griffin hybrid: RG-LRU + local attention, 1:2
[arXiv:2402.19427; hf].

26L d_model=2560 10H (GQA kv=1, i.e. MQA) d_ff=7680 vocab=256000,
pattern (rec, rec, attn), window 2048, lru_width 2560.  Sub-quadratic
(bounded window + O(1) recurrent state): runs the long_500k shape.
"""
from .base import ArchConfig, RGLRUConfig

CONFIG = ArchConfig(
    arch_id="recurrentgemma-2b",
    family="hybrid",
    vocab_size=256000,
    d_model=2560,
    n_layers=26,
    n_heads=10,
    n_kv_heads=1,
    d_ff=7680,
    act="geglu",
    rglru=RGLRUConfig(width=2560, conv_width=4, window=2048,
                      pattern=("rec", "rec", "attn")),
    tie_embeddings=True,
    sub_quadratic=True,
    source="arXiv:2402.19427",
)
