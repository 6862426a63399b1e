"""Shared model components on the paged serve path: embeddings, RoPE,
norms, the SwiGLU MLP, QKV/output projections and paged attention, with
the SOLE technique as the softmax/norm implementation.

Plain functions on tensors, in the JAX package's layouts. Parameters are
stored once in their serving dtype (``cfg.dtype`` for projections,
biases and embeddings — bit-identical to the reference's per-use cast;
float32 for norm gains, which the reference never casts). Under
``cfg.quant.weights`` the projections are packed ``{"q", "s"}`` int8
leaves (``sharding.rules.quantize_params``) and go through
:func:`qmatmul`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import ops
from repro_torch.configs.base import ArchConfig
from repro_torch.core.sole.quant import is_qtensor, quantize_act, true_div

# int8 logit grid for E2Softmax inputs: exp(-12) is below the 4-bit log2
# resolution, so [-12, 0] covers the useful post-max range.
LOGIT_INT8_SCALE = 12.0 / 127.0

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def cast(x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    return x.to(torch_dtype(cfg.dtype))


def qmatmul(x, w, cfg: ArchConfig, n_contract: int = 1) -> torch.Tensor:
    """Matmul against a packed int8 weight ``{"q", "s"}``.

    ``x`` is a plain activation (consumed as it is at w8a16, quantized
    per row on the fly in float32 at w8a8) or an ``(int8 codes, per-row
    scale)`` pair from a ``residual_*_q`` norm, which feeds the w8a8
    matmul directly. Returns float32; call sites cast to the model dtype.
    """
    if isinstance(x, tuple):
        return ops.matmul_fn("w8a8", x[0].device)(x, w, n_contract=n_contract)
    if cfg.quant.acts:
        qx = quantize_act(x.float(), n_contract)
        return ops.matmul_fn("w8a8", x.device)(qx, w, n_contract=n_contract)
    return ops.matmul_fn("w8a16", x.device)(x, w, n_contract=n_contract)


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


def apply_residual_norm(x, r, p, cfg: ArchConfig, phase: str,
                        quant_out: bool = False):
    """``x + r`` followed by the norm: returns (new residual stream,
    normalized output), both in the model dtype. In SOLE mode on CUDA
    the add and calibration are torch ops and the quantize + statistics
    + affine is one kernel pass.

    With ``quant_out`` (and w8a8 active) the ``residual_*_q`` op runs
    instead: the normalized output leaves as an ``(int8 codes, per-row
    scale)`` pair that the next :func:`qmatmul` consumes directly."""
    mode = _norm_mode(cfg, phase)
    if quant_out and cfg.quant.acts:
        fn = ops.residual_norm_q_fn(cfg.norm_kind, mode, x.device)
        if cfg.norm_kind == "layernorm":
            s, out = fn(x, r, p["g"], p["b"])
        else:
            s, out = fn(x, r, p["g"])
        return cast(s, cfg), out
    fn = ops.residual_norm_fn(cfg.norm_kind, mode, x.device)
    if cfg.norm_kind == "layernorm":
        s, out = fn(x, r, p["g"], p["b"])
    else:
        s, out = fn(x, r, p["g"])
    return cast(s, cfg), cast(out, cfg)


# -- embeddings / head -------------------------------------------------------


def embed_tokens(p, tokens: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    return F.embedding(tokens.long(), p["table"])


def lm_logits(p, x, cfg: ArchConfig) -> torch.Tensor:
    if is_qtensor(p["head"]):
        return qmatmul(x, p["head"], cfg)
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


def apply_mlp(x, p, cfg: ArchConfig) -> torch.Tensor:
    """SwiGLU; ``x`` may be an ``(int8 codes, scale)`` pair at w8a8."""
    if cfg.mlp_kind != "swiglu":
        raise NotImplementedError(
            f"mlp_kind {cfg.mlp_kind!r} is not ported yet (ROADMAP.md "
            "queue 1 item 4)")
    if is_qtensor(p["up"]):
        def mm(a, w):
            return cast(qmatmul(a, w, cfg), cfg)
    else:
        def mm(a, w):
            return a @ w
    h = F.silu(mm(x, p["gate"])) * mm(x, p["up"])
    return mm(h, p["down"])


# -- attention ----------------------------------------------------------------


def _project_qkv(p, x, cfg: ArchConfig):
    if is_qtensor(p["wq"]):
        q = cast(qmatmul(x, p["wq"], cfg), cfg)
        k = cast(qmatmul(x, p["wk"], cfg), cfg)
        v = cast(qmatmul(x, p["wv"], cfg), cfg)
    else:
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
    if is_qtensor(p["wo"]):
        return cast(qmatmul(ctx, p["wo"], cfg, n_contract=2), cfg)
    return torch.einsum("bshk,hkd->bsd", ctx, p["wo"])


def _softmax_mode(cfg: ArchConfig, phase: str) -> str:
    return cfg.train_softmax_mode if phase == "train" else cfg.softmax_mode


KV_INT8_SCALE = 1.0 / 16.0  # calibration-provided symmetric scale


def kv_store_dtype(cfg: ArchConfig) -> torch.dtype:
    if cfg.kv_cache_dtype == "int8":
        return torch.int8
    return torch_dtype(cfg.dtype)


def kv_quant(x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """K/V rows as stored in the pages: int8 codes ``clip(round(x /
    KV_INT8_SCALE), -127, 127)`` for int8 pools, else the model dtype."""
    if cfg.kv_cache_dtype == "int8":
        codes = torch.round(true_div(x.float(), KV_INT8_SCALE))
        return torch.clamp(codes, -127, 127).to(torch.int8)
    return x.to(torch_dtype(cfg.dtype))


def kv_dequant(x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    if cfg.kv_cache_dtype == "int8":
        dt = torch_dtype(cfg.dtype)
        return x.to(dt) * torch.tensor(KV_INT8_SCALE, dtype=dt)
    return x


def _paged_kv_scale(cfg: ArchConfig):
    return KV_INT8_SCALE if cfg.kv_cache_dtype == "int8" else None


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
    kv_scale = _paged_kv_scale(cfg)
    return fn(q, pool_k, pool_v, tables, q_start, kv_len, causal=causal,
              exp_bits=cfg.exp_bits,
              int8_scale=(LOGIT_INT8_SCALE if sole and cfg.logit_int8
                          else None),
              kv_scale=kv_scale,
              # w8a8: V stays raw int8 codes through P.V and kv_scale
              # folds into the final row scale (exact: a power of two).
              quant_pv=bool(cfg.quant.acts and kv_scale is not None))
