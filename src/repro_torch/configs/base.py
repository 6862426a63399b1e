"""Architecture configuration: the port's own copy of ``ArchConfig``,
``QuantConfig`` and ``.smoke()`` (held field-for-field equal to the JAX
package's by ``tests/test_torch_package.py``).

Only the architectures this slice serves are registered; other names
raise.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Serving-time quantization knob (SOLE W8A8 pipeline): ``off`` |
    ``w8a16`` | ``w8a8`` (int8 weights; at w8a8 also int8 activations
    between ops)."""

    mode: str = "off"

    def __post_init__(self):
        if self.mode not in ("off", "w8a16", "w8a8"):
            raise ValueError(f"unknown quant mode {self.mode!r}")

    @property
    def weights(self) -> bool:
        """int8 weights resident?"""
        return self.mode in ("w8a16", "w8a8")

    @property
    def acts(self) -> bool:
        """int8 activations flowing between ops?"""
        return self.mode == "w8a8"


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | encdec | vlm | ssm | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 -> d_model // n_heads

    # FFN / activation
    mlp_kind: str = "swiglu"     # swiglu | gelu | relu2 | geglu | rwkv_cmix
    # Norm
    norm_kind: str = "rmsnorm"   # rmsnorm | layernorm
    # Attention
    pos_kind: str = "rope"       # rope | mrope | none
    qkv_bias: bool = False
    window: int = 0              # sliding-window size (0 = full attention)
    causal: bool = True
    rope_theta: float = 10000.0

    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25

    # Enc-dec (whisper)
    n_enc_layers: int = 0
    cross_len: int = 1500

    # Hybrid (recurrentgemma) / ssm (rwkv6)
    block_pattern: Tuple[str, ...] = ()
    n_tail_layers: int = 0
    conv_width: int = 4
    rglru_c: float = 8.0
    rwkv_head_size: int = 64
    rwkv_chunk: int = 0

    # SOLE integration
    softmax_mode: str = "sole"        # exact | sole | softermax | ibert
    norm_mode: str = "sole"           # exact | sole | ibert
    train_softmax_mode: str = "exact"
    train_norm_mode: str = "exact"
    logit_int8: bool = True           # int8-snap attention logits (paper)
    exp_bits: int = 4                 # E2Softmax log2-quant width
    # Kept for field equality with the reference; the port's backend
    # follows the tensors' device instead (see ops/registry.py).
    ops_backend: str = "auto"
    quant: QuantConfig = QuantConfig()

    # Numerics / performance
    dtype: str = "bfloat16"
    attn_impl: str = "auto"
    attn_block: int = 1024
    remat: str = "dots"
    scan_layers: bool = True
    kv_cache_dtype: str = "auto"  # auto (= dtype) | int8
    sharding_strategy: str = "tp"

    skip_shapes: Tuple[str, ...] = ()

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(self.n_heads, 1))

    @property
    def padded_vocab(self) -> int:
        return (self.vocab_size + 127) // 128 * 128

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def smoke(self) -> "ArchConfig":
        """Reduced same-family config for CPU smoke tests."""
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=2,
            n_enc_layers=2 if self.n_enc_layers else 0,
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            head_dim=16,
            d_ff=128,
            vocab_size=512,
            n_experts=4 if self.is_moe else 0,
            top_k=min(self.top_k, 2) if self.is_moe else 0,
            block_pattern=self.block_pattern,
            n_tail_layers=min(self.n_tail_layers, 1),
            cross_len=32,
            rwkv_head_size=16,
            attn_block=32,
            dtype="float32",
        )


ARCH_NAMES = ("qwen2_0_5b", "stablelm_1_6b", "nemotron_4_15b", "minitron_8b")

_REGISTRY = {}


def get_config(name: str) -> ArchConfig:
    key = name.replace("-", "_").replace(".", "_")
    if key not in ARCH_NAMES:
        raise ValueError(
            f"architecture {name!r} is not ported yet (ported: "
            f"{ARCH_NAMES}; see ROADMAP.md queue 1 item 7)")
    if key not in _REGISTRY:
        mod = importlib.import_module(f"repro_torch.configs.{key}")
        _REGISTRY[key] = mod.CONFIG
    return _REGISTRY[key]
