"""Plain torch oracles with the JAX package's ``repro.ops.oracles``
semantics: the two-pass E2Softmax, AILayerNorm on centred integer codes
and attention with E2Softmax (or exact softmax) probabilities. They share
the integer pipeline of ``core.sole``; the kernels' plain versions are
held against them, exactly for integer codes and to float32 tolerance for
float sums.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.sole.ailayernorm import compressed_square, ptf_shift
from repro_torch.core.sole.e2softmax import (ALDIV_BIAS, aldivision,
                                             log2exp)
from repro_torch.core.sole.quant import true_div


def _snap(d: torch.Tensor, int8_scale: Optional[float]) -> torch.Tensor:
    if int8_scale is None:
        return d
    return torch.clamp(torch.round(true_div(d, int8_scale)), -127, 0) \
        * int8_scale


def e2softmax_ref(x: torch.Tensor, *, exp_bits: int = 4,
                  int8_scale: Optional[float] = None) -> torch.Tensor:
    """Two-pass E2Softmax over the last axis."""
    x = x.float()
    d = _snap(x - x.amax(-1, keepdim=True), int8_scale)
    k = log2exp(d, exp_bits=exp_bits)
    s = torch.exp2(-k.float()).sum(-1, keepdim=True)
    return aldivision(k, s)


def ailayernorm_ref(xi: torch.Tensor, alpha: torch.Tensor,
                    gamma: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """Integer AILayerNorm on centred codes ``xi = x_q - zp`` (int32)."""
    c = xi.shape[-1]
    xi = xi.to(torch.int32)
    sq = compressed_square(xi.abs())
    xs = ptf_shift(xi, alpha)
    ex = xs.sum(-1, keepdim=True, dtype=torch.int32)
    ex2 = (sq << (2 * alpha)).sum(-1, keepdim=True, dtype=torch.int32)
    mu = true_div(ex.float(), c)
    var = torch.clamp_min(true_div(ex2.float() * 16.0, c) - mu * mu, 1.0)
    return gamma * torch.rsqrt(var) * (xs.float() - mu) + beta


def flash_e2softmax_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool, exp_bits: int = 4,
                        int8_scale: Optional[float] = None,
                        sole: bool = True) -> torch.Tensor:
    """Attention with two-pass E2Softmax (or exact softmax) weights:
    q, k, v (B, S, d) single-head layout -> (B, S, d) float32."""
    q, kk, vv = q.float(), k.float(), v.float()
    d = q.shape[-1]
    logits = torch.einsum("bsd,btd->bst", q * (d ** -0.5), kk)
    mask = None
    if causal:
        s, t = logits.shape[-2:]
        mask = (torch.arange(s, device=q.device)[:, None]
                >= torch.arange(t, device=q.device)[None, :])
        logits = torch.where(mask, logits, -torch.inf)
    dd = logits - logits.amax(-1, keepdim=True)
    if sole:
        kc = log2exp(_snap(dd, int8_scale), exp_bits=exp_bits)
        p = torch.exp2(-kc.float())
        if mask is not None:
            p = torch.where(mask, p, 0.0)
        mant, expo = torch.frexp(torch.clamp_min(p.sum(-1, keepdim=True),
                                                 1e-38))
        factor = torch.where(mant >= 0.75, ALDIV_BIAS - 0.5, ALDIV_BIAS)
        # ALDivision with k_y = 0: 2^-(k_s + 1) * factor, k_s = expo - 1
        scale = torch.exp2(-expo.float()) * factor
        return torch.einsum("bst,btd->bsd", p, vv) * scale
    p = torch.exp(dd)
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    return torch.einsum("bst,btd->bsd", p, vv) / p.sum(-1, keepdim=True)
