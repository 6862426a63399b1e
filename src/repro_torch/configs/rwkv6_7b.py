"""RWKV-6 (Finch) 7B — attention-free, data-dependent decay [arXiv:2404.05892].

No softmax in the token mixing, so E2Softmax does not apply; AILayerNorm
applies to the LayerNorms and to the per-head GroupNorm (a (64, 64)
affine). O(1) sequence state.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6_7b", family="ssm",
    n_layers=32, d_model=4096, n_heads=64, n_kv_heads=64, head_dim=64,
    d_ff=14336, vocab_size=65536, rwkv_head_size=64,
    mlp_kind="rwkv_cmix", norm_kind="layernorm", pos_kind="none",
)
