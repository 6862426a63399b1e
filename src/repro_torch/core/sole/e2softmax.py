"""E2Softmax — log2-quantized Softmax (SOLE, paper §III-B), two-pass.

1. ``Log2Exp(x) = -round(x * 1.4375)`` for x <= 0 (1.4375 = 1 + 1/2 -
   1/16 approximates 1/ln2), clipped to ``exp_bits`` bits: exp(x) ~=
   2^-k.
2. The sum S = sum_i 2^-k_i is accumulated in float32 (every addend is
   a power of two).
3. ``ALDivision(k_y, S) = 2^-(k_y + k_s + 1) * (1.636 - q)`` where
   ``S = 2^k_s (1 + s)`` and ``q = 0.5`` iff ``s >= 0.5``.

Masked positions contribute exactly zero to S and to the output.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.sole.quant import true_div

# 1/ln2 ~= 1.442695 approximated by shifts: 1 + 1/2 - 1/16 (paper Eq. 8).
INV_LN2_SHIFT_APPROX = 1.4375
# Unbiasedness correction constant (paper Eq. 13).
ALDIV_BIAS = 1.636


def log2exp(x: torch.Tensor, *, exp_bits: int = 4) -> torch.Tensor:
    """-round(log2(e^x)) for x <= 0, clipped to ``exp_bits`` bits."""
    k = torch.round(-x * INV_LN2_SHIFT_APPROX)
    return torch.clamp(k, 0.0, float(2 ** exp_bits - 1)).to(torch.int32)


def _split_sum(s: torch.Tensor):
    """S = 2^k_s (1 + frac) -> (k_s, q) with q the bit below the leading
    one (frexp's mantissa lies in [0.5, 1))."""
    mant, expo = torch.frexp(torch.clamp_min(s, 1e-38))
    return expo.to(torch.int32) - 1, mant >= 0.75


def aldivision(k_y: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Approximate log-based division 2^-k_y / S (paper Eq. 13/17)."""
    k_s, q = _split_sum(s)
    factor = torch.where(q, torch.full_like(s, ALDIV_BIAS - 0.5),
                         torch.full_like(s, ALDIV_BIAS))
    return torch.exp2(-(k_y + k_s + 1).float()) * factor


def e2softmax(x: torch.Tensor, *, axis: int = -1, exp_bits: int = 4,
              mask: Optional[torch.Tensor] = None,
              input_scale: Optional[float] = None) -> torch.Tensor:
    """Two-pass E2Softmax over ``axis``; ``mask`` True = keep.
    ``input_scale`` first snaps the logits to the int8 grid of that scale
    (``clip(round(x / s), -128, 127) * s``, a true division)."""
    x = x.float()
    if input_scale is not None:
        x = torch.clamp(torch.round(true_div(x, input_scale)), -128, 127) \
            * input_scale
    neg = torch.finfo(torch.float32).min
    xm = x if mask is None else torch.where(mask, x, neg)
    m = torch.clamp_min(xm.amax(axis, keepdim=True), neg / 2)
    k = log2exp(xm - m, exp_bits=exp_bits)
    p = torch.exp2(-k.float())
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    s = torch.clamp_min(p.sum(axis, keepdim=True), 2.0 ** -30)
    out = aldivision(k, s)
    if mask is not None:
        out = torch.where(mask, out, 0.0)
    return out
