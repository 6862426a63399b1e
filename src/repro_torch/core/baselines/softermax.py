"""Softermax baseline (Stevens et al., DAC'21): base-2 softmax with
online normalization and low-precision fixed point. Its unnormalized
stage-1 outputs are buffered at 16-bit fixed point (against 4-bit log2
codes in E2Softmax), which drives the memory gap of the paper's §V-D.
"""
from __future__ import annotations

from typing import Optional

import torch

LOG2E = 1.4426950408889634


def _round_fixed(x: torch.Tensor, frac_bits: int) -> torch.Tensor:
    s = float(2 ** frac_bits)
    return torch.round(x * s) / s


def softermax(x: torch.Tensor, *, axis: int = -1, frac_bits: int = 15,
              input_frac_bits: int = 4,
              mask: Optional[torch.Tensor] = None, **kw) -> torch.Tensor:
    """Base-2 softmax with ``frac_bits`` fixed-point unnormalized
    probabilities; the logits (ln 2 folded in) are first rounded to
    ``input_frac_bits`` fractional bits."""
    x = x.float() * LOG2E                   # ln 2 folded into the scale
    x = _round_fixed(x, input_frac_bits)
    neg = torch.finfo(torch.float32).min
    xm = x if mask is None else torch.where(mask, x, neg)
    m = torch.clamp_min(xm.amax(axis, keepdim=True), neg / 2)
    p = _round_fixed(torch.exp2(xm - m), frac_bits)
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    s = torch.clamp_min(p.sum(axis, keepdim=True), 2.0 ** -frac_bits)
    return p / s
