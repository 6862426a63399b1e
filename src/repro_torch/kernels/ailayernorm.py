"""AILayerNorm / AIRMSNorm quantize+norm: the Hopper kernel
(``csrc/ailayernorm.cu``), its wrappers and its plain torch version.

Counterpart of ``repro/kernels/ailayernorm.py``'s ``_qnorm_kernel`` and
the ``params=None`` entry points that reach it (``ailayernorm_pallas``,
``airmsnorm_pallas``, ``fused_add_norm_pallas``): the residual add and
``calibrate_ptf`` run as torch ops over the whole tensor (calibration is
batch-global), then one kernel pass quantizes each row, takes the two
int32 statistics and applies the affine. The static-``params`` fused
kernels are not part of this slice.

:func:`qnorm` given CPU tensors computes the plain version; given CUDA
tensors it launches the kernel or raises.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.sole.ailayernorm import compressed_square, ptf_shift
from repro_torch.core.sole.quant import PTFQuantParams, calibrate_ptf, true_div
from repro_torch.kernels import build

# shared memory holds one row of int32 codes (48 KB without opt-in)
MAX_CHANNELS = 12288


def _inv_sqrt(v: torch.Tensor) -> torch.Tensor:
    """Correctly rounded ``1 / sqrt(v)`` (``torch.rsqrt`` is approximate
    on CUDA)."""
    return torch.ones_like(v) / torch.sqrt(v)


def qnorm_plain(x, denom, alpha, gamma, beta, *, rms: bool) -> torch.Tensor:
    """The kernel's arithmetic in plain torch, in the same order:
    (rows, C) float32 -> (rows, C) float32."""
    c = x.shape[-1]
    xi = torch.clamp(torch.round(x / denom), -128, 127).to(torch.int32)
    sq = compressed_square(xi.abs())
    xs = ptf_shift(xi, alpha)
    ex2 = (sq << (2 * alpha)).sum(-1, keepdim=True, dtype=torch.int32)
    mean_sq = true_div(ex2.float() * 16.0, c)
    if rms:
        rs = _inv_sqrt(torch.clamp_min(mean_sq, 1.0))
        return gamma * xs.float() * rs
    ex = xs.sum(-1, keepdim=True, dtype=torch.int32)
    mu = true_div(ex.float(), c)
    rs = _inv_sqrt(torch.clamp_min(mean_sq - mu * mu, 1.0))
    return gamma * rs * (xs.float() - mu) + beta


def qnorm(x, denom, alpha, gamma, beta, *, rms: bool) -> torch.Tensor:
    """PTF quantize + integer statistics + affine of each row of ``x``
    (rows, C) float32, with per-channel ``denom`` (C,) float32, ``alpha``
    (C,) int32, ``gamma``/``beta`` (C,) float32."""
    if x.device.type == "cpu":
        return qnorm_plain(x, denom, alpha, gamma, beta, rms=rms)
    if x.device.type != "cuda":
        raise ValueError(f"no ailayernorm kernel for device {x.device}")
    if x.ndim != 2 or x.shape[1] > MAX_CHANNELS:
        raise ValueError(f"x must be (rows, C <= {MAX_CHANNELS}), got "
                         f"{tuple(x.shape)}")
    rows, c = x.shape
    for name, t, dt in (("x", x, torch.float32), ("denom", denom, torch.float32),
                        ("alpha", alpha, torch.int32),
                        ("gamma", gamma, torch.float32),
                        ("beta", beta, torch.float32)):
        if t.device != x.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name}: need a contiguous {dt} tensor on "
                             f"{x.device}, got {t.dtype} on {t.device}")
        if t is not x and tuple(t.shape) != (c,):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected ({c},)")
    out = torch.empty_like(x)
    if rows == 0:
        return out
    lib = build.load("ailayernorm")
    fn = build.declare(lib, "ailayernorm_qnorm", 6, 3)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), denom.data_ptr(), alpha.data_ptr(),
                gamma.data_ptr(), beta.data_ptr(), out.data_ptr(), rows, c,
                int(rms), stream)
    build.check(lib, rc, "ailayernorm_qnorm launch")
    qnorm.launches += 1
    return out


qnorm.launches = 0


def _norm_call(x, params: PTFQuantParams, gamma, beta, rms: bool):
    """Flatten to rows, run :func:`qnorm`, restore the shape."""
    c = x.shape[-1]
    x2 = x.reshape(-1, c).float().contiguous()
    out = qnorm(x2, params.denom().contiguous(), params.alpha.contiguous(),
                gamma.float().contiguous(), beta.float().contiguous(), rms=rms)
    return out.reshape(x.shape)


def ailayernorm(x, gamma, beta) -> torch.Tensor:
    """AILayerNorm with on-the-fly PTF calibration (unsigned codes)."""
    return _norm_call(x, calibrate_ptf(x, unsigned=True), gamma, beta, False)


def airmsnorm(x, gamma) -> torch.Tensor:
    """AIRMSNorm with on-the-fly PTF calibration (symmetric codes)."""
    return _norm_call(x, calibrate_ptf(x, unsigned=False), gamma,
                      torch.zeros_like(gamma), True)


def fused_add_norm(x, r, gamma, beta: Optional[torch.Tensor] = None, *,
                   rms: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """``h = x + r`` then the SOLE norm of ``h`` calibrated on ``h``:
    returns ``(h, norm(h))`` — the residual carry and the float32 norm."""
    if beta is None:
        beta = torch.zeros_like(gamma)
    h = x + r
    return h, _norm_call(h, calibrate_ptf(h, unsigned=not rms), gamma, beta,
                         rms)
