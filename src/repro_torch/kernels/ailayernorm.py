"""AILayerNorm / AIRMSNorm: the Hopper kernels (``csrc/ailayernorm.cu``),
their wrappers and their plain torch versions.

Counterpart of ``repro/kernels/ailayernorm.py``, one row body with four
entry points:

* :func:`qnorm` (``_qnorm_kernel``): PTF quantize + integer statistics +
  affine of each row, given per-channel ``denom = s * 2^alpha`` and
  ``alpha``. :func:`ailayernorm`/:func:`airmsnorm` reach it with the
  caller's static params or, without them, after ``calibrate_ptf`` over
  the whole tensor (calibration is batch-global, torch ops);
  :func:`fused_add_norm` without params adds and calibrates as torch ops
  first.
* :func:`add_norm` (``_fused_kernel``): ``h = x + r`` written out, then the
  same body on ``h`` in one pass — :func:`fused_add_norm` with static
  params.
* :func:`add_norm_quant` (``_fused_q_kernel``): the above plus per-row
  symmetric int8 of the normalized row — :func:`fused_add_norm_quant` with
  static params. Its codes and scale equal ``quantize_act`` of
  :func:`add_norm`'s output bit for bit.
* :func:`codes_norm` (``_kernel``, ``ailayernorm_pallas_codes``): the
  statistics and LayerNorm affine on centred int32 codes —
  :func:`ailayernorm_codes`.

Each wrapper given CPU tensors computes the plain version; given CUDA
tensors it launches its kernel or raises.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.sole.ailayernorm import (compressed_square, inv_sqrt,
                                               ptf_shift)
from repro_torch.core.sole.quant import (PTFQuantParams, calibrate_ptf,
                                         quantize_act, true_div)
from repro_torch.kernels import build

# shared memory holds one row of int32 codes (48 KB without opt-in)
MAX_CHANNELS = 12288


def _norm_codes_plain(xi, alpha, gamma, beta, *, rms: bool) -> torch.Tensor:
    """The row body from int32 codes on, in the kernel's order."""
    c = xi.shape[-1]
    sq = compressed_square(xi.abs())
    xs = ptf_shift(xi, alpha)
    ex2 = (sq << (2 * alpha)).sum(-1, keepdim=True, dtype=torch.int32)
    mean_sq = true_div(ex2.float() * 16.0, c)
    if rms:
        rs = inv_sqrt(torch.clamp_min(mean_sq, 1.0))
        return gamma * xs.float() * rs
    ex = xs.sum(-1, keepdim=True, dtype=torch.int32)
    mu = true_div(ex.float(), c)
    rs = inv_sqrt(torch.clamp_min(mean_sq - mu * mu, 1.0))
    return gamma * rs * (xs.float() - mu) + beta


def qnorm_plain(x, denom, alpha, gamma, beta, *, rms: bool) -> torch.Tensor:
    """The kernel's arithmetic in plain torch, in the same order:
    (rows, C) float32 -> (rows, C) float32."""
    xi = torch.clamp(torch.round(x / denom), -128, 127).to(torch.int32)
    return _norm_codes_plain(xi, alpha, gamma, beta, rms=rms)


def add_norm_plain(x, r, denom, alpha, gamma, beta, *,
                   rms: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(h, qnorm(h))`` with ``h = x + r`` in float32."""
    h = x + r
    return h, qnorm_plain(h, denom, alpha, gamma, beta, rms=rms)


def add_norm_quant_plain(x, r, denom, alpha, gamma, beta, *, rms: bool):
    """``(h, int8 codes, (rows, 1) scale)``: :func:`add_norm_plain`, then
    ``quantize_act`` of the norm."""
    h, out = add_norm_plain(x, r, denom, alpha, gamma, beta, rms=rms)
    codes, scale = quantize_act(out)
    return h, codes, scale


def codes_norm_plain(xi, alpha, gamma, beta) -> torch.Tensor:
    """LayerNorm of centred int32 codes (rows, C) -> float32."""
    return _norm_codes_plain(xi, alpha, gamma, beta, rms=False)


def _check_row_args(rows_in, c: int, **args) -> None:
    """Raise unless ``rows_in`` is (rows, C <= MAX_CHANNELS) on the card
    and every tensor of ``args`` (name -> (tensor, dtype, shape)) is
    contiguous, of its dtype and shape and on the same device."""
    dev = rows_in.device
    if dev.type != "cuda":
        raise ValueError(f"no ailayernorm kernel for device {dev}")
    if rows_in.ndim != 2 or c > MAX_CHANNELS:
        raise ValueError(f"x must be (rows, C <= {MAX_CHANNELS}), got "
                         f"{tuple(rows_in.shape)}")
    for name, (t, dt, shape) in args.items():
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name}: need a contiguous {dt} tensor on "
                             f"{dev}, got {t.dtype} on {t.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")


def _chan(denom, alpha, gamma, beta, c: int) -> dict:
    f32 = torch.float32
    out = dict(alpha=(alpha, torch.int32, (c,)), gamma=(gamma, f32, (c,)),
               beta=(beta, f32, (c,)))
    if denom is not None:
        out["denom"] = (denom, f32, (c,))
    return out


def _launch(fn_name: str, n_ptrs: int, n_ints: int, x, args, ints) -> None:
    lib = build.load("ailayernorm")
    fn = build.declare(lib, fn_name, n_ptrs, n_ints)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = fn(*(t.data_ptr() for t in args), *ints, stream)
    build.check(lib, rc, f"{fn_name} launch")


def qnorm(x, denom, alpha, gamma, beta, *, rms: bool) -> torch.Tensor:
    """PTF quantize + integer statistics + affine of each row of ``x``
    (rows, C) float32, with per-channel ``denom`` (C,) float32, ``alpha``
    (C,) int32, ``gamma``/``beta`` (C,) float32."""
    if x.device.type == "cpu":
        return qnorm_plain(x, denom, alpha, gamma, beta, rms=rms)
    rows, c = x.shape[0], x.shape[-1]
    _check_row_args(x, c, x=(x, torch.float32, (rows, c)),
                    **_chan(denom, alpha, gamma, beta, c))
    out = torch.empty_like(x)
    if rows == 0:
        return out
    _launch("ailayernorm_qnorm", 6, 3, x,
            (x, denom, alpha, gamma, beta, out), (rows, c, int(rms)))
    qnorm.launches += 1
    return out


qnorm.launches = 0


def add_norm(x, r, denom, alpha, gamma, beta, *,
             rms: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """``h = x + r`` and the quantize+norm of ``h`` in one pass: x, r
    (rows, C) float32 -> (h, out), both (rows, C) float32."""
    if x.device.type == "cpu":
        return add_norm_plain(x, r, denom, alpha, gamma, beta, rms=rms)
    rows, c = x.shape[0], x.shape[-1]
    _check_row_args(x, c, x=(x, torch.float32, (rows, c)),
                    r=(r, torch.float32, (rows, c)),
                    **_chan(denom, alpha, gamma, beta, c))
    h, out = torch.empty_like(x), torch.empty_like(x)
    if rows == 0:
        return h, out
    _launch("ailayernorm_add_norm", 8, 3, x,
            (x, r, denom, alpha, gamma, beta, h, out), (rows, c, int(rms)))
    add_norm.launches += 1
    return h, out


add_norm.launches = 0


def add_norm_quant(x, r, denom, alpha, gamma, beta, *, rms: bool):
    """:func:`add_norm` with the norm leaving as per-row int8: x, r (rows,
    C) float32 -> (h float32, codes int8 (rows, C), scale float32
    (rows, 1))."""
    if x.device.type == "cpu":
        return add_norm_quant_plain(x, r, denom, alpha, gamma, beta, rms=rms)
    rows, c = x.shape[0], x.shape[-1]
    _check_row_args(x, c, x=(x, torch.float32, (rows, c)),
                    r=(r, torch.float32, (rows, c)),
                    **_chan(denom, alpha, gamma, beta, c))
    h = torch.empty_like(x)
    codes = torch.empty((rows, c), dtype=torch.int8, device=x.device)
    scale = torch.empty((rows, 1), dtype=torch.float32, device=x.device)
    if rows == 0:
        return h, codes, scale
    _launch("ailayernorm_add_norm_quant", 9, 3, x,
            (x, r, denom, alpha, gamma, beta, h, codes, scale),
            (rows, c, int(rms)))
    add_norm_quant.launches += 1
    return h, codes, scale


add_norm_quant.launches = 0


def codes_norm(xi, alpha, gamma, beta) -> torch.Tensor:
    """LayerNorm statistics and affine of centred codes ``xi`` (rows, C)
    int32 with per-channel ``alpha`` (C,) int32 -> (rows, C) float32."""
    if xi.device.type == "cpu":
        return codes_norm_plain(xi, alpha, gamma, beta)
    rows, c = xi.shape[0], xi.shape[-1]
    _check_row_args(xi, c, xi=(xi, torch.int32, (rows, c)),
                    **_chan(None, alpha, gamma, beta, c))
    out = torch.empty((rows, c), dtype=torch.float32, device=xi.device)
    if rows == 0:
        return out
    _launch("ailayernorm_codes", 5, 2, xi, (xi, alpha, gamma, beta, out),
            (rows, c))
    codes_norm.launches += 1
    return out


codes_norm.launches = 0


# -- entry points in the reference's signatures -------------------------------


def _rows(x) -> torch.Tensor:
    return x.reshape(-1, x.shape[-1]).float().contiguous()


def _chan_args(params: PTFQuantParams, gamma, beta):
    return (params.denom().contiguous(), params.alpha.contiguous(),
            gamma.float().contiguous(), beta.float().contiguous())


def _norm_call(x, params: PTFQuantParams, gamma, beta, rms: bool):
    """Flatten to rows, run :func:`qnorm`, restore the shape."""
    out = qnorm(_rows(x), *_chan_args(params, gamma, beta), rms=rms)
    return out.reshape(x.shape)


def ailayernorm(x, gamma, beta, *,
                params: Optional[PTFQuantParams] = None) -> torch.Tensor:
    """AILayerNorm (unsigned codes) with the caller's static PTF params,
    or calibrated on the fly over the whole tensor."""
    if params is None:
        params = calibrate_ptf(x, unsigned=True)
    return _norm_call(x, params, gamma, beta, False)


def airmsnorm(x, gamma, *,
              params: Optional[PTFQuantParams] = None) -> torch.Tensor:
    """AIRMSNorm (symmetric codes), params as :func:`ailayernorm`."""
    if params is None:
        params = calibrate_ptf(x, unsigned=False)
    return _norm_call(x, params, gamma, torch.zeros_like(gamma), True)


def fused_add_norm(x, r, gamma, beta: Optional[torch.Tensor] = None, *,
                   params: Optional[PTFQuantParams] = None,
                   rms: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(h, norm(h))`` with ``h = x + r``: the residual carry and the
    float32 norm. With static ``params`` the add, quantize, statistics and
    affine are one kernel on float32 rows and ``h`` comes back float32;
    without them the add (in the inputs' dtype) and the calibration on
    ``h`` run as torch ops before the quantize+norm kernel."""
    if beta is None:
        beta = torch.zeros_like(gamma)
    if params is None:
        h = x + r
        return h, _norm_call(h, calibrate_ptf(h, unsigned=not rms), gamma,
                             beta, rms)
    h, out = add_norm(_rows(x), _rows(r), *_chan_args(params, gamma, beta),
                      rms=rms)
    return h.reshape(x.shape), out.reshape(x.shape)


def fused_add_norm_quant(x, r, gamma, beta: Optional[torch.Tensor] = None, *,
                         params: Optional[PTFQuantParams] = None,
                         rms: bool = False):
    """:func:`fused_add_norm` with the norm leaving as per-row int8:
    ``(h, (codes, scale))``, the scale (..., 1). With static ``params`` one
    kernel; without them :func:`fused_add_norm`, then ``quantize_act``."""
    if params is None:
        h, out = fused_add_norm(x, r, gamma, beta, rms=rms)
        return h, quantize_act(out)
    if beta is None:
        beta = torch.zeros_like(gamma)
    h, codes, scale = add_norm_quant(_rows(x), _rows(r),
                                     *_chan_args(params, gamma, beta),
                                     rms=rms)
    return (h.reshape(x.shape),
            (codes.reshape(x.shape), scale.reshape(x.shape[:-1] + (1,))))


def ailayernorm_codes(xi, alpha, gamma, beta) -> torch.Tensor:
    """LayerNorm of centred int32 codes ``xi = x_q - zp`` (..., C) with
    per-channel ``alpha`` (C,): the oracle entry point of the op layer."""
    c = xi.shape[-1]
    out = codes_norm(xi.reshape(-1, c).to(torch.int32).contiguous(),
                     alpha.to(torch.int32).contiguous(),
                     gamma.float().contiguous(), beta.float().contiguous())
    return out.reshape(xi.shape)
