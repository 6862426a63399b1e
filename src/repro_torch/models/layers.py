"""Shared model components on the paged serve path: embeddings, RoPE,
norms, the SwiGLU MLP, QKV/output projections and paged attention, with
the SOLE technique as the softmax/norm implementation.

Plain functions on tensors, in the JAX package's layouts. Parameters are
stored once in their serving dtype (``cfg.dtype`` for projections,
biases and embeddings — bit-identical to the reference's per-use cast;
float32 for norm gains, which the reference never casts).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch import ops
from repro_torch.configs.base import ArchConfig

# int8 logit grid for E2Softmax inputs: exp(-12) is below the 4-bit log2
# resolution, so [-12, 0] covers the useful post-max range.
LOGIT_INT8_SCALE = 12.0 / 127.0

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def cast(x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    return x.to(torch_dtype(cfg.dtype))


# -- norms ------------------------------------------------------------------


def _norm_mode(cfg: ArchConfig, phase: str) -> str:
    return cfg.train_norm_mode if phase == "train" else cfg.norm_mode


def apply_norm(x, p, cfg: ArchConfig, phase: str) -> torch.Tensor:
    mode = _norm_mode(cfg, phase)
    if cfg.norm_kind == "layernorm":
        out = ops.layernorm_fn(mode, x.device)(x, p["g"], p["b"])
    else:
        out = ops.rmsnorm_fn(mode, x.device)(x, p["g"])
    return cast(out, cfg)


def apply_residual_norm(x, r, p, cfg: ArchConfig,
                        phase: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x + r`` followed by the norm: returns (new residual stream,
    normalized output), both in the model dtype. In SOLE mode on CUDA
    the add and calibration are torch ops and the quantize + statistics
    + affine is one kernel pass."""
    fn = ops.residual_norm_fn(cfg.norm_kind, _norm_mode(cfg, phase),
                              x.device)
    if cfg.norm_kind == "layernorm":
        s, out = fn(x, r, p["g"], p["b"])
    else:
        s, out = fn(x, r, p["g"])
    return cast(s, cfg), cast(out, cfg)


# -- embeddings / head -------------------------------------------------------


def embed_tokens(p, tokens: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    return F.embedding(tokens.long(), p["table"])


def lm_logits(p, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    return (x @ p["head"]).float()


# -- RoPE ---------------------------------------------------------------------


def rope_freqs(cfg: ArchConfig, device) -> torch.Tensor:
    half = cfg.head_dim // 2
    expo = -torch.arange(half, dtype=torch.float32, device=device) / half
    return torch.pow(torch.tensor(cfg.rope_theta, dtype=torch.float32,
                                  device=device), expo)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               cfg: ArchConfig) -> torch.Tensor:
    """x: (..., S, H, head_dim); positions broadcastable to (..., S)."""
    freqs = rope_freqs(cfg, x.device)
    ang = positions[..., None].float() * freqs
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


# -- MLP ----------------------------------------------------------------------


def apply_mlp(x: torch.Tensor, p, cfg: ArchConfig) -> torch.Tensor:
    if cfg.mlp_kind != "swiglu":
        raise NotImplementedError(
            f"mlp_kind {cfg.mlp_kind!r} is not ported yet (ROADMAP.md "
            "queue 1 item 4)")
    h = F.silu(x @ p["gate"]) * (x @ p["up"])
    return h @ p["down"]


# -- attention ----------------------------------------------------------------


def _project_qkv(p, x: torch.Tensor, cfg: ArchConfig):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    return q, k, v


def _wo_proj(ctx: torch.Tensor, p, cfg: ArchConfig) -> torch.Tensor:
    """Output projection ctx (B,S,H,hd) @ wo (H,hd,D) -> (B,S,D)."""
    return torch.einsum("bshk,hkd->bsd", ctx, p["wo"])


def _softmax_mode(cfg: ArchConfig, phase: str) -> str:
    return cfg.train_softmax_mode if phase == "train" else cfg.softmax_mode


def kv_store_dtype(cfg: ArchConfig) -> torch.dtype:
    if cfg.kv_cache_dtype == "int8":
        raise NotImplementedError(
            "int8 KV pages come with the W8A8 slice (ROADMAP.md queue 1 "
            "item 6)")
    return torch_dtype(cfg.dtype)


def kv_quant(x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    return x.to(kv_store_dtype(cfg))


def paged_attend(q, pool_k, pool_v, tables, q_start, kv_len,
                 cfg: ArchConfig, *, causal: bool) -> torch.Tensor:
    """Attention for C chunk queries per sequence against paged KV.

    q: (B, C, H, hd); pool_k/pool_v: (N, bs, KV, hd) one layer's pool
    (the chunk's own K/V already written); tables: (B, NB) page tables;
    q_start/kv_len: (B,) absolute position of q row 0 / valid key count.
    """
    mode = _softmax_mode(cfg, phase="serve")
    sole = mode == "sole"
    fn = ops.paged_attention_fn(mode, q.device)
    return fn(q, pool_k, pool_v, tables, q_start, kv_len, causal=causal,
              exp_bits=cfg.exp_bits,
              int8_scale=(LOGIT_INT8_SCALE if sole and cfg.logit_int8
                          else None))
