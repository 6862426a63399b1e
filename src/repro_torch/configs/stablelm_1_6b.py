"""StableLM-2-1.6B — dense, MHA (kv=32), LayerNorm [hf:stabilityai/stablelm-2-1_6b]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="stablelm_1_6b", family="dense",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=5632,
    vocab_size=100352, qkv_bias=True,
    mlp_kind="swiglu", norm_kind="layernorm", pos_kind="rope",
    skip_shapes=("long_500k",),
)
