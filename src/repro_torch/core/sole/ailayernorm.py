"""AILayerNorm — approximate integer LayerNorm (SOLE, paper §III-C),
and the AIRMSNorm variant (symmetric codes, no mean term).

On PTF-quantized activations ``X ~= s * 2^alpha_c * (X_q - zp)`` the
statistics are integer: E[x] accumulates ``(X_q - zp) << alpha``, E[x^2]
accumulates dynamic-compression squares ``(y^2 + y) << 4s`` (x^2 / 16)
shifted by ``2 alpha``; the common ``<< 4`` is applied once after the
reduction. The shared scale ``s`` cancels in the normalized value.
All integer arithmetic is int32 and exact. ``1/sigma`` is ``rsqrt`` or,
with ``use_rsqrt_lut``, the LUT-quantized :func:`rsqrt_lut` of the
efficiency ablations.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.sole.quant import (PTFQuantParams, calibrate_ptf,
                                         true_div)


def dynamic_compress(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """8-bit unsigned x -> (y: 4-bit, s: 1-bit) with x ~= y << (2 + 2 s)."""
    x = x.to(torch.int32)
    s = (x >= 64).to(torch.int32)
    y = torch.where(s == 1, x >> 4, x >> 2)
    return y, s


def compressed_square(x_abs: torch.Tensor) -> torch.Tensor:
    """x^2 / 16 via dynamic compression: (y^2 + y) << 4s."""
    y, s = dynamic_compress(x_abs)
    return (y * y + y) << (4 * s)


def ptf_shift(xi: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """``xi << alpha`` for signed codes, as an exact int32 multiply."""
    return xi * (1 << alpha)


def inv_sqrt(v: torch.Tensor) -> torch.Tensor:
    """Correctly rounded ``1 / sqrt(v)`` (``torch.rsqrt`` is approximate
    on CUDA)."""
    return torch.ones_like(v) / torch.sqrt(v)


def rsqrt_lut(v: torch.Tensor, *, bits: int = 8) -> torch.Tensor:
    """LUT-quantized ``v^-1/2`` (the paper's small x^-0.5 LUT): ``v`` is
    normalized to [1, 4) by an even power of two, its mantissa rounded to
    one of ``2^bits`` levels, and the result rescaled by ``2^(-e/2)``."""
    v = torch.clamp_min(v.float(), 1e-12)
    e = torch.floor(torch.log2(v) / 2.0) * 2.0          # even exponent
    m = v * torch.exp2(-e)                              # in [1, 4)
    levels = float(2 ** bits - 1)
    idx = torch.round(true_div(m - 1.0, 3.0) * levels)
    m_q = 1.0 + true_div(idx * 3.0, levels)
    return inv_sqrt(m_q) * torch.exp2(-e / 2.0)


def _inv_std(v: torch.Tensor, use_rsqrt_lut: bool) -> torch.Tensor:
    return rsqrt_lut(v) if use_rsqrt_lut else torch.rsqrt(v)


def ailayernorm_int(x_q: torch.Tensor, alpha: torch.Tensor, zero_point: int,
                    gamma: torch.Tensor, beta: torch.Tensor, *,
                    use_rsqrt_lut: bool = False) -> torch.Tensor:
    """Integer-domain AILayerNorm (paper Alg. 2) over the last axis."""
    c = x_q.shape[-1]
    xi = x_q.to(torch.int32) - zero_point
    sq = compressed_square(xi.abs())
    x_shift = ptf_shift(xi, alpha)
    ex = x_shift.sum(-1, keepdim=True, dtype=torch.int32)
    ex2 = (sq << (2 * alpha)).sum(-1, keepdim=True, dtype=torch.int32)
    mu = ex.float() / c
    var = torch.clamp_min(ex2.float() * 16.0 / c - mu * mu, 1.0)
    a = gamma.float() * _inv_std(var, use_rsqrt_lut)
    return a * (x_shift.float() - mu) + beta.float()


def ailayernorm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, *,
                params: Optional[PTFQuantParams] = None,
                use_rsqrt_lut: bool = False) -> torch.Tensor:
    """AILayerNorm on real-valued inputs; ``params=None`` calibrates PTF
    on the fly over the whole tensor."""
    if params is None:
        params = calibrate_ptf(x, unsigned=True)
    return ailayernorm_int(params.quantize(x), params.alpha,
                           params.zero_point, gamma, beta,
                           use_rsqrt_lut=use_rsqrt_lut)


def airmsnorm_int(x_q: torch.Tensor, alpha: torch.Tensor,
                  gamma: torch.Tensor, *,
                  use_rsqrt_lut: bool = False) -> torch.Tensor:
    """RMSNorm variant: symmetric int8 codes, zp = 0."""
    c = x_q.shape[-1]
    xi = x_q.to(torch.int32)
    sq = compressed_square(xi.abs())
    x_shift = ptf_shift(xi, alpha)
    ex2 = (sq << (2 * alpha)).sum(-1, keepdim=True, dtype=torch.int32)
    ms = torch.clamp_min(ex2.float() * 16.0 / c, 1.0)
    return gamma.float() * x_shift.float() * _inv_std(ms, use_rsqrt_lut)


def airmsnorm(x: torch.Tensor, gamma: torch.Tensor, *,
              params: Optional[PTFQuantParams] = None,
              use_rsqrt_lut: bool = False) -> torch.Tensor:
    if params is None:
        params = calibrate_ptf(x, unsigned=False)
    return airmsnorm_int(params.quantize(x), params.alpha, gamma,
                         use_rsqrt_lut=use_rsqrt_lut)
