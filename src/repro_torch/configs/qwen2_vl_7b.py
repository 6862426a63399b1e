"""Qwen2-VL-7B backbone — M-RoPE, patch frontend stubbed [arXiv:2409.12191].

Prefill takes precomputed patch + text embeddings and 3-axis (temporal,
height, width) position ids; text decode embeds tokens with all three
axes equal. Not paged-servable (served through ``prefill``/
``decode_step`` on a dense cache).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2_vl_7b", family="vlm",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4, d_ff=18944,
    vocab_size=152064, qkv_bias=True,
    mlp_kind="swiglu", norm_kind="rmsnorm", pos_kind="mrope", rope_theta=1e6,
    skip_shapes=("long_500k",),
)
