"""RecurrentGemma-9B — RG-LRU + local attention 1:2 [arXiv:2402.19427].

38 layers = 12 x (rec, rec, attn) blocks + 2 trailing recurrent layers
(26 recurrent : 12 local-attention, 16 query heads on one KV head of
dimension 256). Bounded sequence state.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma_9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1, head_dim=256,
    d_ff=12288, vocab_size=256000,
    block_pattern=("rec", "rec", "attn"), n_tail_layers=2,
    mlp_kind="geglu", norm_kind="rmsnorm", pos_kind="rope", window=2048,
)
