"""Whisper-small backbone — enc-dec, conv frontend stubbed [arXiv:2212.04356].

12 encoder + 12 decoder layers (the published whisper-small layout).
Requests carry precomputed frame embeddings (S_enc, d_model) in place of
the log-mel conv frontend; the paged engine encodes them once at
admission and parks every decoder layer's cross K/V in pages.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper_small", family="encdec",
    n_layers=12, n_enc_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
    d_ff=3072, vocab_size=51865,
    mlp_kind="gelu", norm_kind="layernorm", pos_kind="none",
    skip_shapes=("long_500k",),
)
