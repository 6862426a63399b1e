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

from repro_torch.core.sole.quant import PTFQuantParams, true_div
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
                      input_scale: Optional[float] = None, **kw):
    """The E2Softmax kernel over the last axis; masked entries give exact
    0. ``input_scale`` snaps the logits to its int8 grid before the kernel,
    in their own dtype, as the reference's Pallas adapter does."""
    if axis not in (-1, x.ndim - 1):
        raise ValueError("the e2softmax kernel normalizes the last axis only")
    if input_scale is not None:
        scale = torch.full_like(x, input_scale)
        x = torch.clamp(torch.round(true_div(x, input_scale)), -128, 127) \
            * scale
    return e2softmax(x, exp_bits=exp_bits, mask=mask)


def _static(params) -> Optional[PTFQuantParams]:
    if params is not None and not isinstance(params, PTFQuantParams):
        raise TypeError(f"static params must be PTFQuantParams, got "
                        f"{type(params).__name__}")
    return params


@registry.register("layernorm", "sole", "cuda")
def sole_layernorm_cuda(x, gamma, beta, *, params=None, **kw):
    """The quantize+norm kernel with the caller's static PTF ``params``,
    or calibrated on the fly."""
    return K_norm.ailayernorm(x, gamma, beta, params=_static(params))


@registry.register("rmsnorm", "sole", "cuda")
def sole_rmsnorm_cuda(x, gamma, *, params=None, **kw):
    return K_norm.airmsnorm(x, gamma, params=_static(params))


@registry.register("residual_layernorm", "sole", "cuda")
def sole_residual_layernorm_cuda(x, r, gamma, beta=None, *, params=None,
                                 **kw):
    """Static ``params``: the fused add+norm kernel (``_fused_kernel``);
    without them the add and calibration as torch ops, then the
    quantize+norm kernel."""
    return K_norm.fused_add_norm(x, r, gamma, beta, params=_static(params),
                                 rms=False)


@registry.register("residual_rmsnorm", "sole", "cuda")
def sole_residual_rmsnorm_cuda(x, r, gamma, beta=None, *, params=None,
                               **kw):
    return K_norm.fused_add_norm(x, r, gamma, None, params=_static(params),
                                 rms=True)


def _residual_norm_q(rms: bool):
    def fn(x, r, gamma, beta=None, *, params=None, **kw):
        """``(x + r, (int8 codes, per-row scale))``. Static ``params``:
        the fused add+norm+quantize-out kernel (``_fused_q_kernel``);
        without them the reference's ``params=None`` branch: the add and
        calibration as torch ops, the quantize+norm kernel, then
        ``quantize_act`` of its float32 output."""
        return K_norm.fused_add_norm_quant(
            x, r, gamma, None if rms else beta, params=_static(params),
            rms=rms)
    return fn


registry.register("residual_layernorm_q", "sole", "cuda")(
    _residual_norm_q(rms=False))
registry.register("residual_rmsnorm_q", "sole", "cuda")(
    _residual_norm_q(rms=True))


@registry.register("matmul", "w8a8", "cuda")
def w8a8_matmul_cuda(x, w, *, n_contract: int = 1, **kw):
    """int8 x int8 through the GEMM kernel: both sides flatten to 2-D
    (the contraction axes are contiguous, activation trailing, weight
    leading) and the scales apply afterwards in the reference twin's
    order, so the two agree bit for bit."""
    return w8a8_matmul_with(int8_matmul, x, w, n_contract)


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
