"""Architecture configuration: the port's own copy of ``ArchConfig``,
``QuantConfig``, ``.smoke()``, ``ShapeConfig`` and ``SHAPES`` (held
field-for-field equal to the JAX package's by
``tests/test_torch_package.py``).

Every family of the JAX package is registered; other names raise.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


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
    # auto = the hand-written kernels on CUDA tensors, plain torch on the
    # CPU; reference = plain torch everywhere; cuda = auto, refusing CPU
    # tensors (ops/registry.py). Mode semantics never change with it.
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

    def param_count(self) -> int:
        """Analytic parameter count (embedding + layers + head), the
        reference's formula (``roofline.analysis.model_flops`` takes it)."""
        d, f, h, kv, hd = (self.d_model, self.d_ff, self.n_heads,
                           self.n_kv_heads, self.head_dim)
        attn = d * h * hd + 2 * d * kv * hd + h * hd * d
        if self.mlp_kind in ("swiglu", "geglu"):
            ffn = 3 * d * f
        else:
            ffn = 2 * d * f
        if self.is_moe:
            ffn = ffn * self.n_experts + d * self.n_experts  # + router
        per_layer = attn + ffn + 2 * d
        if self.family == "ssm":  # rwkv6: wkv instead of attention
            tm = 4 * d * d + d * d  # r,k,v,g,o  (+ small loras, decay)
            cm = 2 * d * f + d * d
            per_layer = tm + cm + 2 * d
        emb = self.padded_vocab * d
        n_layers = self.n_layers + self.n_enc_layers
        return emb * 2 + n_layers * per_layer

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k of n_experts)."""
        if not self.is_moe:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        ffn_all = 3 * d * f * self.n_experts
        ffn_act = 3 * d * f * self.top_k
        return self.param_count() - self.n_layers * (ffn_all - ffn_act)

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


ARCH_NAMES = ("qwen2_0_5b", "stablelm_1_6b", "nemotron_4_15b", "minitron_8b",
              "mixtral_8x7b", "dbrx_132b", "rwkv6_7b", "recurrentgemma_9b",
              "whisper_small", "qwen2_vl_7b")

_REGISTRY = {}


def get_config(name: str) -> ArchConfig:
    key = name.replace("-", "_").replace(".", "_")
    if key not in ARCH_NAMES:
        raise ValueError(
            f"architecture {name!r} is not ported yet (ported: "
            f"{ARCH_NAMES})")
    if key not in _REGISTRY:
        mod = importlib.import_module(f"repro_torch.configs.{key}")
        _REGISTRY[key] = mod.CONFIG
    return _REGISTRY[key]
