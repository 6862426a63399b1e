"""Shared model components of the serve paths: embeddings, RoPE, norms,
the MLPs (SwiGLU, GeGLU, GELU, squared ReLU), QKV/output projections,
paged attention, the dense (materialized-logits) attention of the
dense-slot engine and the blocked (online-normalized) attention of long
sequences, with the SOLE technique as the softmax/norm implementation.

Plain functions on tensors, in the JAX package's layouts. Parameters are
stored once in their serving dtype (``cfg.dtype`` for projections,
biases and embeddings — bit-identical to the reference's per-use cast;
float32 for norm gains, which the reference never casts). Under
``cfg.quant.weights`` the projections are packed ``{"q", "s"}`` int8
leaves (``sharding.rules.quantize_params``) and go through
:func:`qmatmul`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import ops
from repro_torch.configs.base import ArchConfig
from repro_torch.core.sole.e2softmax import ALDIV_BIAS, log2exp, split_sum
from repro_torch.core.sole.quant import is_qtensor, quantize_act, true_div
from repro_torch.kernels.flash_e2softmax import exp2_int
from repro_torch.ops.reference import repeat_kv

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
    """The norm in the model dtype; ``out_dtype`` lets a kernel write it
    directly (the other backends' float32 output is cast here)."""
    mode = _norm_mode(cfg, phase)
    kw = dict(out_dtype=torch_dtype(cfg.dtype))
    if cfg.norm_kind == "layernorm":
        out = ops.layernorm_fn(mode, x.device)(x, p["g"], p["b"], **kw)
    else:
        out = ops.rmsnorm_fn(mode, x.device)(x, p["g"], **kw)
    return cast(out, cfg)


def apply_residual_norm(x, r, p, cfg: ArchConfig, phase: str,
                        quant_out: bool = False):
    """``x + r`` followed by the norm: returns (new residual stream,
    normalized output), both in the model dtype. In SOLE mode on CUDA
    the add, the calibration and the quantize + statistics + affine are
    one kernel launch, which writes the output in the model dtype.

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
    kw = dict(out_dtype=torch_dtype(cfg.dtype))
    if cfg.norm_kind == "layernorm":
        s, out = fn(x, r, p["g"], p["b"], **kw)
    else:
        s, out = fn(x, r, p["g"], **kw)
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

# feed-forward kinds of the dense family; the gated ones carry a "gate"
# projection beside "up" and "down"
MLP_KINDS = ("swiglu", "geglu", "gelu", "relu2")
GATED_MLP_KINDS = ("swiglu", "geglu")


def apply_mlp(x, p, cfg: ArchConfig) -> torch.Tensor:
    """The feed-forward block of ``cfg.mlp_kind``: ``swiglu`` and
    ``geglu`` (gate, up, down), ``gelu`` and ``relu2`` (up, down). GELU
    is the tanh form (``jax.nn.gelu``'s default); ``relu2`` squares in
    the model dtype. ``x`` may be an ``(int8 codes, scale)`` pair at
    w8a8; the ``down`` input is then quantized per row on the fly."""
    kind = cfg.mlp_kind
    if kind not in MLP_KINDS:
        raise ValueError(f"unknown mlp_kind {kind!r}")
    if is_qtensor(p["up"]):
        def mm(a, w):
            return cast(qmatmul(a, w, cfg), cfg)
    else:
        def mm(a, w):
            return a @ w
    if kind == "swiglu":
        h = F.silu(mm(x, p["gate"])) * mm(x, p["up"])
    elif kind == "geglu":
        h = F.gelu(mm(x, p["gate"]), approximate="tanh") * mm(x, p["up"])
    elif kind == "gelu":
        h = F.gelu(mm(x, p["up"]), approximate="tanh")
    else:
        h = torch.square(F.relu(mm(x, p["up"])))
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


# -- dense and blocked attention (whole sequences) ------------------------------

_BLOCK_NEG = -1e30                 # the blocked path's masked logit
_LN2E = 1.4426950408889634


def _mask(q_pos, k_pos, cfg: ArchConfig, causal: bool) -> torch.Tensor:
    """(..., S_q, S_k) boolean mask from positions; padded keys carry
    position 2**30."""
    m = k_pos[..., None, :] < 2 ** 29
    m = torch.broadcast_to(m, tuple(q_pos.shape) + (k_pos.shape[-1],))
    if causal:
        m = m & (q_pos[..., :, None] >= k_pos[..., None, :])
    if cfg.window:
        m = m & ((q_pos[..., :, None] - k_pos[..., None, :]) < cfg.window)
    return m


def _sole_probs(logits, mask, cfg: ArchConfig, out_dtype) -> torch.Tensor:
    """SOLE attention probabilities in ``out_dtype``, one op call (one
    kernel launch on CUDA): the masked row max (floored for fully masked
    rows), the int8 snap of ``logits - max`` (``int8_scale``) and
    E2Softmax, the reference's max, subtract, snap, op and cast."""
    return ops.softmax_fn("sole", logits.device)(
        logits, mask=mask, exp_bits=cfg.exp_bits,
        int8_scale=LOGIT_INT8_SCALE if cfg.logit_int8 else None,
        out_dtype=out_dtype)


def attend_dense(q, k, v, q_pos, k_pos, cfg: ArchConfig, phase: str,
                 causal: bool = True) -> torch.Tensor:
    """Materialized-logits attention. q (B,S,H,hd), k/v (B,T,KV,hd);
    positions (S,)/(T,) shared or (B,S)/(B,T) per lane. The logits are the
    model-dtype product, then float32, as in the reference."""
    b, s, h, hd = q.shape
    k = repeat_kv(k, h)
    v = repeat_kv(v, h)
    qs = q * (hd ** -0.5)
    logits = torch.einsum("bshd,bthd->bhst", qs, k).float()
    mask = _mask(q_pos, k_pos, cfg, causal)          # (s, t) or (b, s, t)
    if mask.ndim == 3:                               # per-lane positions
        mask = mask[:, None]
    mask = torch.broadcast_to(mask, logits.shape)
    mode = _softmax_mode(cfg, phase)
    if mode == "sole":
        probs = _sole_probs(logits, mask, cfg, q.dtype)
    else:
        probs = ops.softmax_fn(mode, q.device)(logits, mask=mask).to(q.dtype)
    return torch.einsum("bhst,bthd->bshd", probs, v)


def _online_chunk(qc, qp, kb, vb, pb, cfg: ArchConfig, sole: bool,
                  causal: bool, out_dtype) -> torch.Tensor:
    """One q chunk's pass over the k-blocks: qc (b, qblk, h, hd) at
    positions qp (qblk,); kb/vb (nkb, b, blk, h, hd) at pb (nkb, blk).
    Returns (b, h, qblk, hd) in ``out_dtype``."""
    b, qblk, h, hd = qc.shape
    qs = (qc * (hd ** -0.5)).float()
    dev = qc.device
    m_run = torch.full((b, h, qblk), _BLOCK_NEG, device=dev)
    s_run = torch.zeros((b, h, qblk), device=dev)
    acc = torch.zeros((b, h, qblk, hd), device=dev)
    for kc, vc, pc in zip(kb, vb, pb):
        logits = torch.einsum("bshd,bthd->bhst", qs, kc.float())
        mask = torch.broadcast_to(_mask(qp, pc, cfg, causal), logits.shape)
        logits = torch.where(mask, logits, _BLOCK_NEG)
        m_new = torch.maximum(m_run, logits.amax(-1))
        if sole:
            d = ops.snap_logits(logits - m_new[..., None],
                                LOGIT_INT8_SCALE if cfg.logit_int8 else None)
            kcode = log2exp(d, exp_bits=cfg.exp_bits)
            w = torch.where(mask, exp2_int(-kcode), 0.0)
            sub = log2exp(m_run - m_new, exp_bits=cfg.exp_bits + 2)
            corr = exp2_int(-sub)
        else:
            w = torch.where(mask, torch.exp2((logits - m_new[..., None])
                                             * _LN2E), 0.0)
            corr = torch.exp2((m_run - m_new) * _LN2E)
        s_run = s_run * corr + w.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bhst,bthd->bhsd", w,
                                                   vc.float())
        m_run = m_new
    s_run = torch.clamp_min(s_run, 2.0 ** -30)
    if sole:
        # ALDivision with k_y = 0: per row 2^-(k_s + 1) (1.636 - q)
        k_s, q = split_sum(s_run)
        scale = exp2_int(-(k_s + 1)) * torch.where(q, ALDIV_BIAS - 0.5,
                                                   ALDIV_BIAS)
    else:
        scale = 1.0 / s_run
    return (acc * scale[..., None]).to(out_dtype)


def attend_blocked(q, k, v, q_pos, k_pos, cfg: ArchConfig, phase: str,
                   causal: bool = True) -> torch.Tensor:
    """Online-normalized blocked attention (one flash-style pass), tiled
    over Q and KV in blocks of ``cfg.attn_block``: q (B,S,H,hd), k/v
    (B,T,KV,hd), shared positions (S,)/(T,). Returns (B,S,H,hd).

    In SOLE mode each k-block's post-max logits are snapped to the int8
    grid and weighted by their 4-bit codes ``2^-k``; the running sum is
    rescaled by the quantized correction ``2^-Log2Exp(m_old - m_new)``
    (``exp_bits + 2`` bits) and ALDivision scales each row once at the
    end. Powers of two are built from exponent bits. With a sliding
    window (causal) each q chunk scans only its key band."""
    b, s, h, hd = q.shape
    k = repeat_kv(k, h)
    v = repeat_kv(v, h)
    t = k.shape[1]
    blk = min(cfg.attn_block, t)
    padk = (-t) % blk
    if padk:
        k = F.pad(k, (0, 0, 0, 0, 0, padk))
        v = F.pad(v, (0, 0, 0, 0, 0, padk))
        k_pos = F.pad(k_pos, (0, padk), value=2 ** 30)
    tk = t + padk
    qblk = min(cfg.attn_block, s)
    padq = (-s) % qblk
    if padq:
        q = F.pad(q, (0, 0, 0, 0, 0, padq))
        q_pos = F.pad(q_pos, (0, padq))
    nqb = (s + padq) // qblk
    sole = _softmax_mode(cfg, phase) == "sole"

    def blocks(kk, vv, pp):
        n = kk.shape[1] // blk
        return (kk.reshape(b, n, blk, h, hd).transpose(0, 1),
                vv.reshape(b, n, blk, h, hd).transpose(0, 1),
                pp.reshape(n, blk))

    band = cfg.window and causal and tk > cfg.window + blk
    if band:
        # a q chunk starting at q0 sees keys in [q0 - window + 1, q0 +
        # qblk) only: scan that fixed-size band of K/V
        span = min(-(-(cfg.window + qblk) // blk) * blk, tk)
    else:
        kb, vb, pb = blocks(k, v, k_pos)
    ctx = []
    for i in range(nqb):
        if band:
            start = min(max(i * qblk + qblk - span, 0), tk - span)
            kb, vb, pb = blocks(k[:, start:start + span],
                                v[:, start:start + span],
                                k_pos[start:start + span])
        ctx.append(_online_chunk(q[:, i * qblk:(i + 1) * qblk],
                                 q_pos[i * qblk:(i + 1) * qblk], kb, vb, pb,
                                 cfg, sole, causal, q.dtype))
    ctx = torch.cat(ctx, 2).transpose(1, 2)          # (b, S + padq, h, hd)
    return ctx[:, :s]


def apply_attention(p, x, positions, cfg: ArchConfig, phase: str,
                    causal: Optional[bool] = None) -> torch.Tensor:
    """Self-attention over x (B,S,D) at ``positions`` (S,): dense, or
    blocked under ``attn_impl="blocked"`` (``auto`` picks it from 8192
    tokens on)."""
    causal = cfg.causal if causal is None else causal
    q, k, v = _project_qkv(p, x, cfg)
    if cfg.pos_kind == "rope":
        q = apply_rope(q, positions, cfg)
        k = apply_rope(k, positions, cfg)
    attend = (attend_blocked if attn_impl(cfg, x.shape[1]) == "blocked"
              else attend_dense)
    ctx = attend(q, k, v, positions, positions, cfg, phase, causal=causal)
    return _wo_proj(ctx, p, cfg)


def attn_impl(cfg: ArchConfig, s: int) -> str:
    """``cfg.attn_impl`` for a sequence of ``s`` tokens: ``auto`` is
    blocked from 8192 tokens on, dense below."""
    if cfg.attn_impl == "auto":
        return "blocked" if s >= 8192 else "dense"
    return cfg.attn_impl


def decode_attend_stacked(p, x1, ck, cv, cpos, layer_idx: int, pos,
                          cfg: ArchConfig, slot: int
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token attention against the stacked dot-layout caches
    ck (L,B,KV,hd,T) and cv (L,B,KV,T,hd), which are only read here: the
    current token's (k, v) is attended as column T+1 and returned, and the
    caller writes every layer's column after the layer loop. ``cpos`` is
    the position ring (T,) or per lane (B,T); ``pos`` scalar or per lane
    (B,); ``slot`` the ring column this step writes (its stale content is
    masked out). The logits are float32 products of the model-dtype
    operands. Returns (attn_out, k_col (B,KV,hd,1), v_row (B,KV,1,hd)).
    """
    q, k, v = _project_qkv(p, x1, cfg)
    if cfg.pos_kind == "rope":
        rp = pos[:, None] if pos.ndim else pos[None]
        q = apply_rope(q, rp, cfg)
        k = apply_rope(k, rp, cfg)
    t = ck.shape[-1]
    kl = kv_dequant(ck[layer_idx], cfg)                  # (B,KV,hd,T)
    vl = kv_dequant(cv[layer_idx], cfg)                  # (B,KV,T,hd)
    b, _, h, hd = q.shape
    kvh = kl.shape[1]
    g = h // kvh
    cpos2 = cpos if cpos.ndim == 2 else cpos[None]       # (1|B, T)
    pos2 = (pos if pos.ndim else pos[None])[:, None]     # (1|B, 1)
    valid = cpos2 <= pos2
    if cfg.window:
        valid = valid & ((pos2 - cpos2) < cfg.window)
    valid = valid & (torch.arange(t, device=q.device)[None] != slot)
    mode = _softmax_mode(cfg, phase="serve")
    qg = (q * (hd ** -0.5)).reshape(b, kvh, g, hd)
    kc = k.reshape(b, kvh, 1, hd)                        # current token
    vc = v.reshape(b, kvh, 1, hd)
    logits_c = torch.einsum("bkgd,bkdt->bkgt", qg.float(), kl.float())
    logit_s = torch.einsum("bkgd,bkxd->bkgx", qg.float(),
                           kc.to(qg.dtype).float())
    logits = torch.cat([logits_c, logit_s], -1)          # (B,KV,g,T+1)
    mask = torch.cat(
        [torch.broadcast_to(valid[:, None, None, :], (b, kvh, g, t)),
         torch.ones((b, kvh, g, 1), dtype=torch.bool, device=q.device)], -1)
    if mode == "sole":
        probs = _sole_probs(logits, mask, cfg, q.dtype)
    else:
        probs = ops.softmax_fn(mode, q.device)(logits, mask=mask).to(q.dtype)
    ctx = torch.einsum("bkgt,bktd->bkgd", probs[..., :t], vl)
    ctx = ctx + probs[..., t:] * vc
    out = _wo_proj(ctx.reshape(b, 1, h, hd), p, cfg)
    k_col = kv_quant(k, cfg).permute(0, 2, 3, 1)         # (B,KV,hd,1)
    v_row = kv_quant(v, cfg).permute(0, 2, 1, 3)         # (B,KV,1,hd)
    return out, k_col, v_row


def write_kv_columns(ck, cv, k_cols, v_rows, slot: int) -> None:
    """Write all layers' decode columns, k_cols (L,B,KV,hd,1) and v_rows
    (L,B,KV,1,hd), into the stacked caches at ring column ``slot``, in
    place."""
    ck[..., slot] = k_cols[..., 0].to(ck.dtype)
    cv[..., slot, :] = v_rows[..., 0, :].to(cv.dtype)


def pack_prefill_cache(k, v, positions, t: int, cfg: ArchConfig):
    """One layer's prefill K/V (B,S,KV,hd) -> the dot-layout rings
    (B,KV,hd,T) and (B,KV,T,hd) and their positions, (T,) shared or (B,T)
    per lane (pad slots hold 2**30)."""
    s = k.shape[1]
    if s >= t:
        kk, vv, pp = k[:, -t:], v[:, -t:], positions[..., -t:]
    else:
        kk = F.pad(k, (0, 0, 0, 0, 0, t - s))
        vv = F.pad(v, (0, 0, 0, 0, 0, t - s))
        pp = F.pad(positions, (0, t - s), value=2 ** 30)
    if cfg.window:
        shift = s % t if s >= t else 0
        kk = torch.roll(kk, shift, 1)
        vv = torch.roll(vv, shift, 1)
        pp = torch.roll(pp, shift, -1)
    kq = kv_quant(kk, cfg).permute(0, 2, 3, 1).contiguous()
    vq = kv_quant(vv, cfg).permute(0, 2, 1, 3).contiguous()
    return kq, vq, pp.to(torch.int32)
