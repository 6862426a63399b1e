"""Nemotron-4-15B — dense, GQA kv=8, squared-ReLU FFN [arXiv:2402.16819]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="nemotron_4_15b", family="dense",
    n_layers=32, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=24576,
    vocab_size=256000,
    mlp_kind="relu2", norm_kind="layernorm", pos_kind="rope",
    skip_shapes=("long_500k",),
)
