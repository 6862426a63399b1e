"""CUDA backend: registry adapters over the hand-written Hopper kernels,
in the JAX package's public layouts (q (B, C, H, hd) at the op and
(B, H, C, hd) at the kernel; pools (N, bs, KV, hd)).

Each adapter hands its tensors to the kernel's wrapper, which launches
the kernel on CUDA tensors (or raises) and computes the plain version
on CPU tensors.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.kernels import ailayernorm as K_norm
from repro_torch.kernels.flash_e2softmax import flash_e2softmax_paged
from repro_torch.ops import registry
from repro_torch.ops.reference import paged_meta


@registry.register("layernorm", "sole", "cuda")
def sole_layernorm_cuda(x, gamma, beta, **kw):
    return K_norm.ailayernorm(x, gamma, beta)


@registry.register("rmsnorm", "sole", "cuda")
def sole_rmsnorm_cuda(x, gamma, **kw):
    return K_norm.airmsnorm(x, gamma)


@registry.register("residual_layernorm", "sole", "cuda")
def sole_residual_layernorm_cuda(x, r, gamma, beta=None, **kw):
    return K_norm.fused_add_norm(x, r, gamma, beta, rms=False)


@registry.register("residual_rmsnorm", "sole", "cuda")
def sole_residual_rmsnorm_cuda(x, r, gamma, beta=None, **kw):
    return K_norm.fused_add_norm(x, r, gamma, None, rms=True)


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
