"""DBRX-132B — MoE, 16 experts top-4, fine-grained [hf:databricks/dbrx-base]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="dbrx_132b", family="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=10752,
    vocab_size=100352, n_experts=16, top_k=4,
    mlp_kind="swiglu", norm_kind="layernorm", pos_kind="rope",
    skip_shapes=("long_500k",),  # full attention: 500k decode not sub-quadratic
)
