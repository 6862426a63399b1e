"""CUDA backend: registry adapters over the hand-written Hopper kernels,
in the JAX package's public layouts (q (B, C, H, hd) at the op and
(B, H, C, hd) at the kernel; pools (N, bs, KV, hd)).

Each adapter hands its tensors to the kernel's wrapper, which launches
the kernel on CUDA tensors (or raises) and computes the plain version
on CPU tensors.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.sole.quant import PTFQuantParams, quantize_act, true_div
from repro_torch.kernels import ailayernorm as K_norm
from repro_torch.kernels.e2softmax import e2softmax
from repro_torch.kernels.flash_e2softmax import (flash_e2softmax,
                                                 flash_e2softmax_paged)
from repro_torch.kernels.int8_matmul import int8_matmul
from repro_torch.ops import registry
from repro_torch.ops.reference import (repeat_kv, fold_heads, paged_meta,
                                       w8a8_matmul_with)


@registry.register("softmax", "sole", "cuda")
def sole_softmax_cuda(x, *, axis: int = -1, mask=None, exp_bits: int = 4,
                      input_scale: Optional[float] = None,
                      int8_scale: Optional[float] = None, out_dtype=None,
                      **kw):
    """The E2Softmax kernel over the last axis; masked entries give exact
    0. ``input_scale`` snaps the logits to its int8 grid before the kernel,
    in their own dtype, as the reference's Pallas adapter does;
    ``int8_scale`` is the kernel's own snap of ``x - max`` (the masked max)
    and ``out_dtype`` (float32 by default, or bf16) the type it writes:
    with both, one launch computes what the dense path's max, subtract,
    snap, E2Softmax and cast computed."""
    if axis not in (-1, x.ndim - 1):
        raise ValueError("the e2softmax kernel normalizes the last axis only")
    if input_scale is not None:
        scale = torch.full_like(x, input_scale)
        x = torch.clamp(torch.round(true_div(x, input_scale)), -128, 127) \
            * scale
    return e2softmax(x, exp_bits=exp_bits, mask=mask, int8_scale=int8_scale,
                     out_dtype=out_dtype or torch.float32)


def _static(params) -> Optional[PTFQuantParams]:
    if params is not None and not isinstance(params, PTFQuantParams):
        raise TypeError(f"static params must be PTFQuantParams, got "
                        f"{type(params).__name__}")
    return params


@registry.register("layernorm", "sole", "cuda")
def sole_layernorm_cuda(x, gamma, beta, *, params=None, out_dtype=None,
                        amax_reduce=None, **kw):
    """The quantize+norm kernel with the caller's static PTF ``params``
    (one launch on contiguous float32 or bf16 rows, read as they are);
    without them the calibrating norm kernel (calibration over the whole
    tensor and the norm in one launch). ``out_dtype`` (float32 by default,
    or x's dtype) is the type the kernel writes the output in.
    ``amax_reduce``: ``x`` is a share of the batch's rows, calibrated over
    the whole batch (``calibrated_norm_split``)."""
    return K_norm.ailayernorm(x, gamma, beta, params=_static(params),
                              out_dtype=out_dtype, amax_reduce=amax_reduce)


@registry.register("rmsnorm", "sole", "cuda")
def sole_rmsnorm_cuda(x, gamma, *, params=None, out_dtype=None,
                      amax_reduce=None, **kw):
    return K_norm.airmsnorm(x, gamma, params=_static(params),
                            out_dtype=out_dtype, amax_reduce=amax_reduce)


@registry.register("residual_layernorm", "sole", "cuda")
def sole_residual_layernorm_cuda(x, r, gamma, beta=None, *, params=None,
                                 out_dtype=None, amax_reduce=None, **kw):
    """Static ``params``: the fused add+norm kernel (``_fused_kernel``),
    one launch on float32 or bf16 rows, ``h`` in float32; without them
    the calibrating norm kernel: the add, the calibration and the
    quantize+norm in one launch."""
    return K_norm.fused_add_norm(x, r, gamma, beta, params=_static(params),
                                 rms=False, out_dtype=out_dtype,
                                 amax_reduce=amax_reduce)


@registry.register("residual_rmsnorm", "sole", "cuda")
def sole_residual_rmsnorm_cuda(x, r, gamma, beta=None, *, params=None,
                               out_dtype=None, amax_reduce=None, **kw):
    return K_norm.fused_add_norm(x, r, gamma, None, params=_static(params),
                                 rms=True, out_dtype=out_dtype,
                                 amax_reduce=amax_reduce)


def _residual_norm_q(rms: bool):
    def fn(x, r, gamma, beta=None, *, params=None, amax_reduce=None, **kw):
        """``(x + r, (int8 codes, per-row scale))``. Static ``params``:
        the fused add+norm+quantize-out kernel (``_fused_q_kernel``);
        without them the calibrating norm kernel with its quantize-out:
        the reference's ``params=None`` branch (the add, the calibration,
        the quantize+norm and ``quantize_act`` of its float32 output) in
        one launch."""
        return K_norm.fused_add_norm_quant(
            x, r, gamma, None if rms else beta, params=_static(params),
            rms=rms, amax_reduce=amax_reduce)
    return fn


registry.register("residual_layernorm_q", "sole", "cuda")(
    _residual_norm_q(rms=False))
registry.register("residual_rmsnorm_q", "sole", "cuda")(
    _residual_norm_q(rms=True))


# The exact mode's float norms: the row-stable exact-norm kernel (one
# reduction order per row whatever the row count), with the reference
# backend's defaults for eps; the residual add and ``quantize_act`` stay
# elementwise / per-row torch ops, which are row-stable already.

@registry.register("layernorm", "exact", "cuda")
def exact_layernorm_cuda(x, gamma, beta, *, eps=1e-5, out_dtype=None, **kw):
    return K_norm.exact_norm(x, gamma, beta, rms=False, eps=eps,
                             out_dtype=out_dtype)


@registry.register("rmsnorm", "exact", "cuda")
def exact_rmsnorm_cuda(x, gamma, *, eps=1e-6, out_dtype=None, **kw):
    return K_norm.exact_norm(x, gamma, rms=True, eps=eps, out_dtype=out_dtype)


def _exact_residual_norm(rms: bool, quant_out: bool):
    eps_default = 1e-6 if rms else 1e-5

    def fn(x, r, gamma, beta=None, *, eps=eps_default, out_dtype=None, **kw):
        """``(x + r, norm(x + r))`` (``quant_out``: the norm as ``(int8
        codes, per-row scale)``), the sum in the inputs' dtype as in the
        reference backend."""
        s = x + r
        out = K_norm.exact_norm(s, gamma, None if rms else beta, rms=rms,
                                eps=eps,
                                out_dtype=None if quant_out else out_dtype)
        return s, (quantize_act(out) if quant_out else out)
    return fn


for _kind, _rms in (("layernorm", False), ("rmsnorm", True)):
    registry.register(f"residual_{_kind}", "exact", "cuda")(
        _exact_residual_norm(_rms, quant_out=False))
    registry.register(f"residual_{_kind}_q", "exact", "cuda")(
        _exact_residual_norm(_rms, quant_out=True))


@registry.register("matmul", "w8a8", "cuda")
def w8a8_matmul_cuda(x, w, *, n_contract: int = 1, acc_reduce=None, **kw):
    """int8 x int8 through the GEMM kernel: both sides flatten to 2-D
    (the contraction axes are contiguous, activation trailing, weight
    leading) and the scales apply afterwards in the reference twin's
    order, so the two agree bit for bit."""
    return w8a8_matmul_with(int8_matmul, x, w, n_contract, acc_reduce)


def _flash_attention(sole: bool):
    def fn(q, k, v, *, causal: bool = True, exp_bits: int = 4,
           int8_scale: Optional[float] = None, block: int = 128,
           exact_corr: bool = False, **kw):
        """The dense Flash-E2Softmax kernel in model layout: q (B, S, H,
        hd), k/v (B, T, KV, hd) -> (B, S, H, hd) in q.dtype. K/V are
        repeated to every query head and folded to (B * H, T, hd) here, so
        the kernel sees single-head attention, as in the reference."""
        b, s, h, hd = q.shape
        out = flash_e2softmax(
            fold_heads(q), fold_heads(repeat_kv(k, h)),
            fold_heads(repeat_kv(v, h)), causal=causal, sole=sole,
            exp_bits=exp_bits, int8_scale=int8_scale, block_q=block,
            block_k=block, exact_corr=exact_corr)
        return out.reshape(b, h, s, hd).transpose(1, 2).to(q.dtype)
    return fn


registry.register("flash_attention", "exact", "cuda")(
    _flash_attention(sole=False))
registry.register("flash_attention", "sole", "cuda")(
    _flash_attention(sole=True))


def _paged_attention(sole: bool):
    def fn(q, pool_k, pool_v, tables, q_start, kv_len, *, causal: bool,
           exp_bits: int = 4, int8_scale: Optional[float] = None,
           kv_scale: Optional[float] = None, quant_pv: bool = False,
           kv_head_map=None, **kw):
        """Streams pages through the paged Flash-E2Softmax kernel:
        q (B, C, H, hd) -> (B, C, H, hd) in q.dtype."""
        ctx = flash_e2softmax_paged(
            q.transpose(1, 2).contiguous(), pool_k, pool_v,
            tables.to(q.device).int().contiguous(),
            paged_meta(q_start, kv_len), causal=causal, sole=sole,
            exp_bits=exp_bits, int8_scale=int8_scale, kv_scale=kv_scale,
            quant_pv=quant_pv, kv_head_map=kv_head_map)
        return ctx.transpose(1, 2).to(q.dtype)
    return fn


registry.register("paged_attention", "exact", "cuda")(
    _paged_attention(sole=False))
registry.register("paged_attention", "sole", "cuda")(
    _paged_attention(sole=True))
