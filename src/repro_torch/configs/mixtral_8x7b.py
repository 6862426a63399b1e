"""Mixtral-8x7B — MoE 8 experts top-2, sliding-window attention [arXiv:2401.04088]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mixtral_8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab_size=32000, n_experts=8, top_k=2,
    mlp_kind="swiglu", norm_kind="rmsnorm", pos_kind="rope",
    rope_theta=1e6, window=4096,
    # SWA bounds the KV cache => long_500k decode runs (state = 4096 window).
)
