"""mamba2-2.7b — Mamba-2 SSD, attention-free [arXiv:2405.21060; unverified].

64L d_model=2560 d_ff=0 vocab=50280, ssm_state=128.  d_inner = 2*d_model,
head_dim 64 => 80 heads; the SSD (state-space duality) mixer is the whole
block (no separate FFN).  Sub-quadratic: runs the long_500k shape.
"""
from .base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    arch_id="mamba2-2.7b",
    family="ssm",
    vocab_size=50280,
    d_model=2560,
    n_layers=64,
    n_heads=80,            # d_inner / head_dim
    n_kv_heads=80,
    d_ff=0,
    attn_kind="none",
    ssm=SSMConfig(d_inner=5120, head_dim=64, state_dim=128, n_groups=1,
                  conv_width=4, chunk=128),
    tie_embeddings=True,
    sub_quadratic=True,
    source="arXiv:2405.21060",
)
