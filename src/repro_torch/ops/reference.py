"""Reference backend: plain torch versions of the ops the port serves.

Signatures match the JAX package's registry, which this backend covers
pair for pair:

  softmax(x, *, axis=-1, mask=None, ...)   exact | sole | softermax | ibert
  layernorm(x, gamma, beta)            rmsnorm(x, gamma)   exact|sole|ibert
  residual_layernorm(x, r, gamma, beta) -> (x + r, norm(x + r))
  residual_rmsnorm(x, r, gamma)         -> (x + r, norm(x + r))
  residual_{layernorm,rmsnorm}_q(...)   -> (x + r, (int8 codes, row scale))
  matmul(x, w, *, n_contract)           exact | w8a16 | w8a8
  flash_attention(q, k, v, *, causal, ...)       model layout (B,S,H,hd)
  paged_attention(q, pool_k, pool_v, tables, q_start, kv_len, *, causal, ...)

``flash_attention`` is the two-pass oracle, like the JAX reference: in
SOLE mode the dense kernel's per-k-block quantized correction differs
from it once the keys span more than one block. The exact and SOLE paged
attention here is the paged kernel's own plain version — one online
update per page — not the reference package's gather-and-two-pass oracle,
for the same reason; the baseline modes, which have no kernel, take the
reference's gather-and-two-pass form.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.baselines.ibert import i_layernorm, i_softmax
from repro_torch.core.baselines.softermax import softermax
from repro_torch.core.sole.ailayernorm import ailayernorm, airmsnorm
from repro_torch.core.sole.e2softmax import e2softmax, snap_input
from repro_torch.core.sole.quant import quantize_act
from repro_torch.kernels.ailayernorm import exact_norm_plain
from repro_torch.kernels.flash_e2softmax import (default_kv_head_map,
                                                 flash_e2softmax_paged_plain,
                                                 snap_reciprocal)
from repro_torch.kernels.int8_matmul import int8_matmul_plain
from repro_torch.ops import oracles, registry


# -- softmax ------------------------------------------------------------------


@registry.register("softmax", "exact", "reference")
def exact_softmax(x, *, axis=-1, mask=None, **kw):
    x = x.float()
    if mask is not None:
        x = torch.where(mask, x, torch.finfo(torch.float32).min)
    out = torch.softmax(x, dim=axis)
    if mask is not None:
        out = torch.where(mask, out, 0.0)
    return out


@registry.register("softmax", "sole", "reference")
def sole_softmax(x, *, axis=-1, mask=None, exp_bits: int = 4,
                 input_scale=None, int8_scale: Optional[float] = None,
                 out_dtype=None, **kw):
    """Two-pass E2Softmax. ``int8_scale`` first snaps ``x`` minus its
    masked row max (floored at -1e30 for fully masked rows) to the int8
    grid (:func:`snap_logits`), the chain the dense path ran before the
    op; ``out_dtype`` casts the float32 result."""
    if int8_scale is not None:
        if input_scale is not None:
            x = snap_input(x, input_scale)
            input_scale = None
        x = x.float()
        xm = x if mask is None else torch.where(mask, x, -torch.inf)
        m = torch.clamp_min(xm.amax(axis, keepdim=True), -1e30)
        x = snap_logits(x - m, int8_scale)
    out = e2softmax(x, axis=axis, exp_bits=exp_bits, mask=mask,
                    input_scale=input_scale)
    return out if out_dtype is None else out.to(out_dtype)


registry.register("softmax", "softermax", "reference")(softermax)
registry.register("softmax", "ibert", "reference")(i_softmax)


def snap_logits(d: torch.Tensor, int8_scale: Optional[float]) -> torch.Tensor:
    """int8-grid snap of post-max logits (paper: 8-bit softmax inputs):
    ``clip(round(d * float32(1 / s)), -127, 0) * s``. The JAX model steps
    snap inside ``jit``, where XLA rewrites ``d / s`` for the constant
    ``s`` into this multiply; it differs from the true division at rare
    ties (3 of 2e6 random logits), so the port takes the jitted form."""
    if int8_scale is None:
        return d
    inv = snap_reciprocal(int8_scale)
    return torch.clamp(torch.round(d * inv), -127, 0) * int8_scale


# -- norms --------------------------------------------------------------------


@registry.register("layernorm", "exact", "reference")
def exact_layernorm(x, gamma, beta, *, eps=1e-5, **kw):
    return exact_norm_plain(x, gamma, beta, rms=False, eps=eps)


@registry.register("rmsnorm", "exact", "reference")
def exact_rmsnorm(x, gamma, *, eps=1e-6, **kw):
    return exact_norm_plain(x, gamma, rms=True, eps=eps)


@registry.register("layernorm", "sole", "reference")
def sole_layernorm(x, gamma, beta, *, out_dtype=None, **kw):
    """float32 out; ``out_dtype`` (the type a kernel may write directly) is
    left to the caller's cast here, as in the other modes."""
    return ailayernorm(x, gamma, beta, **kw)


@registry.register("rmsnorm", "sole", "reference")
def sole_rmsnorm(x, gamma, *, out_dtype=None, **kw):
    return airmsnorm(x, gamma, **kw)


@registry.register("layernorm", "ibert", "reference")
def ibert_layernorm(x, gamma, beta, **kw):
    return i_layernorm(x, gamma, beta)


@registry.register("rmsnorm", "ibert", "reference")
def ibert_rmsnorm(x, gamma, **kw):
    """I-BERT has no RMSNorm: its LayerNorm with beta = 0, mean kept."""
    return i_layernorm(x, gamma, torch.zeros_like(gamma))


def _residual_norm(norm_mode: str, kind: str):
    def fn(x, r, gamma, beta=None, **kw):
        s = x + r
        if kind == "layernorm":
            out = registry.resolve("layernorm", norm_mode, "reference")(
                s, gamma, beta, **kw)
        else:
            out = registry.resolve("rmsnorm", norm_mode, "reference")(
                s, gamma, **kw)
        return s, out
    return fn


for _mode in registry.NORM_MODES:
    registry.register("residual_layernorm", _mode, "reference")(
        _residual_norm(_mode, "layernorm"))
    registry.register("residual_rmsnorm", _mode, "reference")(
        _residual_norm(_mode, "rmsnorm"))


def _residual_norm_q(norm_mode: str, kind: str):
    base = _residual_norm(norm_mode, kind)

    def fn(x, r, gamma, beta=None, **kw):
        s, out = base(x, r, gamma, beta, **kw)
        return s, quantize_act(out.float())
    return fn


for _mode in registry.NORM_MODES:
    registry.register("residual_layernorm_q", _mode, "reference")(
        _residual_norm_q(_mode, "layernorm"))
    registry.register("residual_rmsnorm_q", _mode, "reference")(
        _residual_norm_q(_mode, "rmsnorm"))


# -- quantized matmul ---------------------------------------------------------
#
# The activation's trailing ``n_contract`` axes contract against the
# weight's leading ``n_contract`` axes; the per-channel weight scale
# (leading size-1 axes) and the per-row activation scale (trailing size-1
# axes) apply once, after the reduction.


def wscale(w, n_contract: int) -> torch.Tensor:
    """Per-channel scale reshaped to the output axes it broadcasts over."""
    return w["s"].reshape(w["s"].shape[n_contract:])


def w8a8_matmul_with(int_mm, x, w, n_contract: int,
                     acc_reduce=None) -> torch.Tensor:
    """Flatten the contraction axes to 2-D, take the exact int32 product
    with ``int_mm`` ((M, K) int8, (K, N) int8 -> (M, N) int32), then
    ``acc * sx * sw`` in float32, left to right, as the reference.
    ``acc_reduce`` sums a row-parallel product's int32 partials over the
    ranks first (exact)."""
    q, sx = x
    qw = w["q"]
    batch, out_dims = q.shape[:q.ndim - n_contract], qw.shape[n_contract:]
    k = qw.shape[:n_contract].numel()
    acc = int_mm(q.reshape(-1, k).contiguous(), qw.reshape(k, -1).contiguous())
    if acc_reduce is not None:
        acc = acc_reduce(acc)
    acc = acc.reshape(batch + out_dims)
    sx = sx.reshape(sx.shape[:sx.ndim - n_contract] + (1,) * len(out_dims))
    return acc.float() * sx.float() * wscale(w, n_contract)


@registry.register("matmul", "exact", "reference")
def exact_matmul(x, w, *, n_contract: int = 1, **kw):
    return torch.tensordot(x, w, n_contract)


@registry.register("matmul", "w8a16", "reference")
def w8a16_matmul(x, w, *, n_contract: int = 1, **kw):
    """fp activations x int8 weight codes, the per-channel scale applied
    once after the contraction."""
    out = torch.tensordot(x, w["q"].to(x.dtype), n_contract)
    return out * wscale(w, n_contract).to(out.dtype)


@registry.register("matmul", "w8a8", "reference")
def w8a8_matmul(x, w, *, n_contract: int = 1, acc_reduce=None, **kw):
    """int8 x int8 with exact int32 sums; ``x`` is a ``(codes, per-row
    scale)`` pair."""
    return w8a8_matmul_with(int8_matmul_plain, x, w, n_contract, acc_reduce)


# -- attention ----------------------------------------------------------------


def repeat_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """GQA: repeat each KV head (axis 2) for its group of query heads."""
    kvh = k.shape[2]
    if kvh == n_heads:
        return k
    return torch.repeat_interleave(k, n_heads // kvh, dim=2)


def fold_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, S, H, hd) -> (B * H, S, hd), the kernels' single-head layout."""
    b, s, h, hd = x.shape
    return x.transpose(1, 2).reshape(b * h, s, hd)


def _flash_attention_ref(sole: bool):
    def fn(q, k, v, *, causal: bool = True, exp_bits: int = 4,
           int8_scale: Optional[float] = None, **kw):
        """q (B, S, H, hd), k/v (B, T, KV, hd) -> (B, S, H, hd) in
        q.dtype, through the two-pass oracle."""
        b, s, h, hd = q.shape
        out = oracles.flash_e2softmax_ref(
            fold_heads(q), fold_heads(repeat_kv(k, h)),
            fold_heads(repeat_kv(v, h)), causal=causal, sole=sole,
            exp_bits=exp_bits, int8_scale=int8_scale)
        return out.reshape(b, h, s, hd).transpose(1, 2).to(q.dtype)
    return fn


registry.register("flash_attention", "exact", "reference")(
    _flash_attention_ref(sole=False))
registry.register("flash_attention", "sole", "reference")(
    _flash_attention_ref(sole=True))


def paged_meta(q_start, kv_len) -> torch.Tensor:
    """(B, 2) int32 rows (q_start, kv_len) — the paged kernel's metadata."""
    return torch.stack([q_start.to(torch.int32), kv_len.to(torch.int32)], 1)


def _paged_attention_ref(sole: bool):
    def fn(q, pool_k, pool_v, tables, q_start, kv_len, *, causal: bool,
           exp_bits: int = 4, int8_scale: Optional[float] = None,
           kv_scale: Optional[float] = None, quant_pv: bool = False,
           kv_head_map=None, **kw):
        """q (B, C, H, hd); pools (N, bs, KV, hd), int8 codes when
        ``kv_scale`` is given; tables (B, NB); q_start/kv_len (B,) ->
        (B, C, H, hd) in q.dtype."""
        if kv_head_map is None:
            kv_head_map = default_kv_head_map(q.shape[2], pool_k.shape[2],
                                              q.device)
        ctx = flash_e2softmax_paged_plain(
            q.transpose(1, 2), pool_k, pool_v, tables,
            paged_meta(q_start, kv_len), kv_head_map, causal=causal,
            sole=sole, exp_bits=exp_bits, int8_scale=int8_scale,
            kv_scale=kv_scale, quant_pv=quant_pv)
        return ctx.transpose(1, 2).to(q.dtype)
    return fn


registry.register("paged_attention", "exact", "reference")(
    _paged_attention_ref(sole=False))
registry.register("paged_attention", "sole", "reference")(
    _paged_attention_ref(sole=True))


def _paged_attention_gather(mode: str):
    def fn(q, pool_k, pool_v, tables, q_start, kv_len, *, causal: bool,
           kv_scale: Optional[float] = None, quant_pv: bool = False,
           kv_head_map=None, **kw):
        """The reference's gather-and-two-pass paged attention, for the
        softmax modes with no kernel: pages gathered to a contiguous
        cache, the mode's softmax over the masked logits; q (B, C, H, hd)
        -> (B, C, H, hd) in q.dtype."""
        b, c, h, hd = q.shape
        n, bs, kvh, _ = pool_k.shape
        idx = tables.long().reshape(-1)
        k = pool_k[idx].reshape(b, -1, kvh, hd)
        v = pool_v[idx].reshape(b, -1, kvh, hd)
        pv_scale = None
        if kv_scale is not None:                        # int8 page pools
            scale = torch.tensor(kv_scale, dtype=q.dtype)
            k = k.to(q.dtype) * scale
            if quant_pv:
                pv_scale = kv_scale
                v = v.to(q.dtype)
            else:
                v = v.to(q.dtype) * scale
        t = k.shape[1]
        if kv_head_map is not None:
            kf = k.to(q.dtype)[:, :, kv_head_map.long()]
            vf = v.to(q.dtype)[:, :, kv_head_map.long()]
        else:
            kf = repeat_kv(k.to(q.dtype), h)
            vf = repeat_kv(v.to(q.dtype), h)
        logits = torch.einsum("bchd,bthd->bhct", q * (hd ** -0.5),
                              kf).float()
        cols = torch.arange(t, device=q.device)[None, None, None, :]
        mask = cols < kv_len.to(q.device)[:, None, None, None]
        if causal:
            rows = (q_start.to(q.device)[:, None]
                    + torch.arange(c, device=q.device)[None])
            mask = mask & (rows[:, None, :, None] >= cols)
        mask = torch.broadcast_to(mask, logits.shape)
        probs = registry.resolve("softmax", mode, "reference")(logits,
                                                               mask=mask)
        ctx = torch.einsum("bhct,bthd->bchd", probs.to(q.dtype), vf)
        if pv_scale is not None:
            ctx = ctx * torch.tensor(pv_scale, dtype=ctx.dtype)
        return ctx
    return fn


for _mode in ("softermax", "ibert"):
    registry.register("paged_attention", _mode, "reference")(
        _paged_attention_gather(_mode))
