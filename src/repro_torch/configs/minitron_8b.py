"""Minitron-8B — pruned Nemotron-4, GQA kv=8, squared-ReLU [arXiv:2407.14679]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="minitron_8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=16384,
    vocab_size=256000,
    mlp_kind="relu2", norm_kind="layernorm", pos_kind="rope",
    skip_shapes=("long_500k",),
)
