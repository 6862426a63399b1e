"""Qwen2-0.5B — dense, GQA kv=2, QKV bias [arXiv:2407.10671]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2_0_5b", family="dense",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, d_ff=4864,
    vocab_size=151936, qkv_bias=True,
    mlp_kind="swiglu", norm_kind="rmsnorm", pos_kind="rope", rope_theta=1e6,
    skip_shapes=("long_500k",),
)
