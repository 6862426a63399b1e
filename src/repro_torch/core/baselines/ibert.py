"""I-BERT baseline (Kim et al., ICML'21): integer-only softmax and
LayerNorm, the int32 polynomial kernels SOLE compares against: i-exp (a
second-order polynomial on [-ln 2, 0] plus a shift), i-softmax and
i-layernorm (integer Newton square root). All integer arithmetic is int32
with floor division, as the published algorithm (and the reference's
``jnp`` int32, which wraps the same way on overflow).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.core.sole.quant import true_div

# exp(p) ~= a (p + b)^2 + c on p in [-ln2, 0]
_A, _B, _C = 0.3585, 1.353, 0.344
_LN2 = 0.6931471805599453


def i_poly_exp(q: torch.Tensor, scale: float) -> Tuple[torch.Tensor, float]:
    """Integer polynomial for exp on ``q * scale`` in [-ln 2, 0]."""
    qb = int(math.floor(_B / scale))
    qc = int(math.floor(_C / (_A * scale * scale)))
    out = (q + qb) * (q + qb) + qc
    return out.to(torch.int32), _A * scale * scale


def i_exp(q: torch.Tensor, scale: float) -> Tuple[torch.Tensor, float]:
    """i-exp: ``exp(q * scale)`` for q <= 0 by range reduction over ln 2."""
    q_ln2 = max(int(math.floor(_LN2 / scale)), 1)
    z = torch.clamp_max(torch.div(-q, q_ln2, rounding_mode="floor"), 30)
    p = q + z * q_ln2                      # in (-q_ln2, 0]
    q_out, out_scale = i_poly_exp(p, scale)
    return q_out >> z, out_scale


def i_softmax(x: torch.Tensor, *, axis: int = -1, scale: float = 1.0 / 64.0,
              out_bits: int = 8, mask: Optional[torch.Tensor] = None,
              **kw) -> torch.Tensor:
    """Integer-only softmax: int8-grid logits, i-exp, integer divide."""
    x = x.float()
    neg = torch.finfo(torch.float32).min
    xm = x if mask is None else torch.where(mask, x, neg)
    q = torch.clamp(torch.round(true_div(xm, scale)), -2.0 ** 20,
                    2.0 ** 20)
    m = torch.clamp_min(q.amax(axis, keepdim=True), -2.0 ** 20)
    q_exp, _ = i_exp((q - m).to(torch.int32), scale)
    if mask is not None:
        q_exp = torch.where(mask, q_exp, 0)
    s = torch.clamp_min(q_exp.sum(axis, keepdim=True, dtype=torch.int32), 1)
    # I-BERT: factor = floor(2^31 / sum); out = exp * factor >> (31 - b)
    factor = torch.div(torch.full_like(s, 2 ** 31 - 1), s,
                       rounding_mode="floor")
    out_q = torch.floor(q_exp.float() * factor.float()
                        / float(2 ** (31 - out_bits)))
    return out_q / float(2 ** out_bits)


def _bit_length(n: torch.Tensor) -> torch.Tensor:
    """Bits of ``max(n, 1)`` (int32), by exact comparisons with 2^b."""
    n = torch.clamp_min(n.to(torch.int32), 1)
    powers = torch.ones(31, dtype=torch.int32, device=n.device) \
        << torch.arange(31, dtype=torch.int32, device=n.device)
    return (n[..., None] >= powers).sum(-1, dtype=torch.int32)


def i_sqrt(n: torch.Tensor, iters: int = 10) -> torch.Tensor:
    """Integer Newton iteration for ``floor(sqrt(n))``, n int32 >= 0."""
    one = torch.ones_like(n, dtype=torch.int32)
    x = torch.clamp_min(one << torch.div(_bit_length(n) + 1, 2,
                                         rounding_mode="floor"), 1)
    for _ in range(iters):
        x = torch.clamp_min(torch.div(
            x + torch.div(n, torch.clamp_min(x, 1), rounding_mode="floor"),
            2, rounding_mode="floor"), 1)
    return x


def i_layernorm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, *,
                scale: float = 1.0 / 16.0) -> torch.Tensor:
    """Integer-only LayerNorm: int32 statistics and the integer Newton
    square root; the normalized value in 2^10 fixed point."""
    c = x.shape[-1]
    q = torch.clamp(torch.round(true_div(x.float(), scale)),
                    -2.0 ** 15, 2.0 ** 15).to(torch.int32)
    mu = torch.div(q.sum(-1, keepdim=True, dtype=torch.int32), c,
                   rounding_mode="floor")
    d = q - mu
    var = torch.div((d * d).sum(-1, keepdim=True, dtype=torch.int32), c,
                    rounding_mode="floor")
    std = i_sqrt(var)
    f = 10
    norm = torch.div(d * 2 ** f, torch.clamp_min(std, 1),
                     rounding_mode="floor")
    return gamma * norm.float() / float(2 ** f) + beta
