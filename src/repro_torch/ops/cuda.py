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

from repro_torch.core.sole.quant import quantize_act, true_div
from repro_torch.kernels import ailayernorm as K_norm
from repro_torch.kernels.e2softmax import e2softmax
from repro_torch.kernels.flash_e2softmax import flash_e2softmax_paged
from repro_torch.kernels.int8_matmul import int8_matmul
from repro_torch.ops import registry
from repro_torch.ops.reference import paged_meta, w8a8_matmul_with


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


@registry.register("layernorm", "sole", "cuda")
def sole_layernorm_cuda(x, gamma, beta, **kw):
    return K_norm.ailayernorm(x, gamma, beta)


@registry.register("rmsnorm", "sole", "cuda")
def sole_rmsnorm_cuda(x, gamma, **kw):
    return K_norm.airmsnorm(x, gamma)


def _no_static_params(params, kernel: str) -> None:
    if params is not None:
        raise NotImplementedError(
            f"static PTF params run the reference's {kernel}, which has no "
            "Hopper kernel yet (ROADMAP.md queue 2)")


@registry.register("residual_layernorm", "sole", "cuda")
def sole_residual_layernorm_cuda(x, r, gamma, beta=None, *, params=None,
                                 **kw):
    _no_static_params(params, "_fused_kernel")
    return K_norm.fused_add_norm(x, r, gamma, beta, rms=False)


@registry.register("residual_rmsnorm", "sole", "cuda")
def sole_residual_rmsnorm_cuda(x, r, gamma, beta=None, *, params=None,
                               **kw):
    _no_static_params(params, "_fused_kernel")
    return K_norm.fused_add_norm(x, r, gamma, None, rms=True)


def _residual_norm_q(rms: bool):
    def fn(x, r, gamma, beta=None, *, params=None, **kw):
        """The reference's ``params=None`` branch of
        ``fused_add_norm_quant_pallas``: the add and calibration as torch
        ops, the quantize+norm kernel, then ``quantize_act`` of its
        float32 output -> ``(x + r, (int8 codes, per-row scale))``."""
        _no_static_params(params, "_fused_q_kernel")
        h, out = K_norm.fused_add_norm(x, r, gamma, None if rms else beta,
                                       rms=rms)
        return h, quantize_act(out)
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
