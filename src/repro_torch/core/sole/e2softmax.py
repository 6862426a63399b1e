"""E2Softmax — log2-quantized Softmax (SOLE, paper §III-B), two-pass.

1. ``Log2Exp(x) = -round(x * 1.4375)`` for x <= 0 (1.4375 = 1 + 1/2 -
   1/16 approximates 1/ln2), clipped to ``exp_bits`` bits: exp(x) ~=
   2^-k.
2. The sum S = sum_i 2^-k_i is accumulated in float32 (every addend is
   a power of two).
3. ``ALDivision(k_y, S) = 2^-(k_y + k_s + 1) * (1.636 - q)`` where
   ``S = 2^k_s (1 + s)`` and ``q = 0.5`` iff ``s >= 0.5``.

Masked positions contribute exactly zero to S and to the output.

:func:`e2softmax` is the two-pass dataflow (global max known);
:func:`e2softmax_online` the streaming one (paper Alg. 1: running max and
sum, the sum rescaled by a quantized power-of-two correction), a Python
loop over blocks in place of the reference's ``lax.scan``.
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


def snap_input(x: torch.Tensor, input_scale: float) -> torch.Tensor:
    """float32 ``x`` on the int8 grid of ``input_scale``:
    ``clip(round(x / s), -128, 127) * s`` (a true division)."""
    return torch.clamp(torch.round(true_div(x.float(), input_scale)),
                       -128, 127) * input_scale


def e2softmax(x: torch.Tensor, *, axis: int = -1, exp_bits: int = 4,
              mask: Optional[torch.Tensor] = None,
              input_scale: Optional[float] = None) -> torch.Tensor:
    """Two-pass E2Softmax over ``axis``; ``mask`` True = keep.
    ``input_scale`` first snaps the logits to the int8 grid of that scale
    (``clip(round(x / s), -128, 127) * s``, a true division)."""
    x = x.float() if input_scale is None else snap_input(x, input_scale)
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


def e2softmax_online(x: torch.Tensor, *, block: int = 128, exp_bits: int = 4,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Streaming E2Softmax over the last axis, in blocks of ``block``.

    Carries a running (max, sum); on a max update the sum is rescaled by
    ``2^-Log2Exp(m_old - m_new)`` (``exp_bits + 2`` bits). Stage 2 adds
    each block's correction ``Log2Exp(m_block - m_global)`` to its stored
    4-bit codes, then ALDivision."""
    x = x.float()
    n = x.shape[-1]
    pad = (-n) % block
    neg = torch.finfo(torch.float32).min / 2
    if mask is None:
        mask = torch.ones(x.shape, dtype=torch.bool, device=x.device)
    mask = torch.broadcast_to(mask, x.shape)
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
        mask = torch.nn.functional.pad(mask, (0, pad))
    m_run = torch.full(x.shape[:-1] + (1,), neg, device=x.device)
    s_run = torch.zeros(x.shape[:-1] + (1,), device=x.device)
    ks, ms = [], []
    for j in range(x.shape[-1] // block):
        xi = x[..., j * block:(j + 1) * block]
        mi = mask[..., j * block:(j + 1) * block]
        xi = torch.where(mi, xi, neg)
        m_new = torch.maximum(m_run, xi.amax(-1, keepdim=True))
        sub = log2exp(m_run - m_new, exp_bits=exp_bits + 2)
        k = log2exp(xi - m_new, exp_bits=exp_bits)
        p = torch.where(mi, torch.exp2(-k.float()), 0.0)
        s_run = s_run * torch.exp2(-sub.float()) + p.sum(-1, keepdim=True)
        m_run = m_new
        ks.append(k)
        ms.append(m_new.expand_as(k))
    k_blk, m_blk = torch.cat(ks, -1), torch.cat(ms, -1)
    sub = log2exp(m_blk - m_run, exp_bits=exp_bits + 2)
    k_tot = torch.clamp(k_blk + sub, 0, 2 ** (exp_bits + 2) - 1)
    out = aldivision(k_tot, torch.clamp_min(s_run, 2.0 ** -30))
    out = torch.where(mask, out, 0.0)
    return out[..., :n]


def pack_e2(k_tot: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Pack (k, q) into a uint8 code: k in [0, 31] (5 bits), q 1 bit."""
    return (torch.clamp(k_tot.to(torch.int32), 0, 31) * 2
            + q.to(torch.int32)).to(torch.uint8)


def unpack_e2(code: torch.Tensor) -> torch.Tensor:
    """Decode a packed E2Softmax output back to float probabilities."""
    code = code.to(torch.int32)
    k = (code >> 1).float()
    q = (code & 1).float()
    return torch.exp2(-(k + 1.0)) * (ALDIV_BIAS - 0.5 * q)
