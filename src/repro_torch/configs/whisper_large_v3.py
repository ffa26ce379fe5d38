"""whisper-large-v3 — encoder-decoder audio backbone
[arXiv:2212.04356; unverified].

32L (x2: encoder+decoder) d_model=1280 20H (kv=20) d_ff=5120 vocab=51866.
The conv/mel frontend is a STUB: input_specs() supplies precomputed frame
embeddings [B, n_frames, d_model] (n_frames padded 1500 -> 1536 so the
encoder sequence shards over the 16-way model axis).  Decoder uses RoPE in
place of whisper's learned positions (uniform decode path; noted in
DESIGN.md).  Full (quadratic) attention => long_500k skipped.
"""
from .base import ArchConfig, EncoderConfig

CONFIG = ArchConfig(
    arch_id="whisper-large-v3",
    family="audio",
    vocab_size=51866,
    d_model=1280,
    n_layers=32,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    norm="layer",
    act="gelu",
    encoder=EncoderConfig(n_layers=32, n_frames=1536),
    source="arXiv:2212.04356",
)
