"""E2Softmax over the last axis: the Hopper kernel (``csrc/e2softmax.cu``),
its wrapper and its plain torch version.

Counterpart of ``repro/kernels/e2softmax.py``'s ``_kernel`` and
``_masked_kernel`` (entry point ``e2softmax_pallas``): max, optional int8
snap of ``x - max``, 4-bit log2 codes ``k``, ``S = sum 2^-k``, ALDivision
``2^-(k + e) * {1.636, 1.136}``; the snap multiplies by ``float32(1/s)``,
as the jitted Pallas call does (XLA rewrites its division by the static
scale); with a mask (True = keep) masked entries
give exactly 0 and a fully masked row gives a row of zeros. Logits are
float32 or bf16 with any leading dims; the output is float32.

:func:`e2softmax` given CPU tensors computes the plain version; given CUDA
tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.sole.e2softmax import ALDIV_BIAS, INV_LN2_SHIFT_APPROX
from repro_torch.kernels import build
from repro_torch.kernels.flash_e2softmax import (MAX_EXP_BITS, exp2_int,
                                                 snap_reciprocal)

_TYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_VEC = {torch.float32: 4, torch.bfloat16: 8}     # elements per 16-byte load


def e2softmax_plain(x, *, exp_bits: int = 4,
                    int8_scale: Optional[float] = None,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's arithmetic in plain torch, in the same order, on any
    device: ``x`` (..., C) -> (..., C) float32; ``mask`` (..., C) bool or
    uint8 (non-zero = keep)."""
    x = x.float()
    neg = torch.finfo(torch.float32).min
    if mask is None:
        xm = x
        m = x.amax(-1, keepdim=True)
    else:
        keep = mask != 0
        xm = torch.where(keep, x, neg)
        m = torch.clamp_min(xm.amax(-1, keepdim=True), neg / 2)
    d = xm - m
    if int8_scale is not None:
        d = torch.clamp(torch.round(d * snap_reciprocal(int8_scale)),
                        -127, 0) * int8_scale
    k = torch.clamp(torch.round(-d * INV_LN2_SHIFT_APPROX), 0,
                    2 ** exp_bits - 1).to(torch.int32)
    p = exp2_int(-k)
    if mask is not None:
        p = torch.where(keep, p, 0.0)
    s = p.sum(-1, keepdim=True)
    s = torch.clamp_min(s, 2.0 ** -30 if mask is not None else 1e-38)
    mant, expo = torch.frexp(s)
    factor = torch.where(mant >= 0.75, ALDIV_BIAS - 0.5, ALDIV_BIAS).float()
    out = exp2_int(-(k + expo)) * factor
    if mask is not None:
        out = torch.where(keep, out, 0.0)
    return out


def _launch(x, mask, *, exp_bits, int8_scale) -> torch.Tensor:
    if x.dtype not in _TYPE_CODES:
        raise TypeError(f"x dtype {x.dtype}: the kernel takes float32 or "
                        "bfloat16")
    c = x.shape[-1]
    rows = x.numel() // max(c, 1)
    if mask is not None:
        if mask.device != x.device:
            raise ValueError(f"mask is on {mask.device}, x on {x.device}")
        if mask.dtype not in (torch.bool, torch.uint8):
            raise TypeError(f"mask dtype {mask.dtype}: need bool or uint8")
        if tuple(mask.shape) != tuple(x.shape) or not mask.is_contiguous():
            raise ValueError(f"mask must be contiguous with x's shape "
                             f"{tuple(x.shape)}, got {tuple(mask.shape)}")
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    if rows == 0 or c == 0:
        return out
    if rows >= 2 ** 31:
        raise ValueError(f"{rows} rows: the kernel takes fewer than 2^31")
    n = _VEC[x.dtype]
    vec = int(c % n == 0 and x.data_ptr() % 16 == 0
              and (mask is None or mask.data_ptr() % n == 0))
    lib = build.load("e2softmax")
    fn = build.declare(lib, "e2softmax", 3, 6, 2)
    snap = int8_scale is not None
    rc = build.launch(
        x.device, fn, x.data_ptr(), None if mask is None else mask.data_ptr(),
        out.data_ptr(), rows, c, exp_bits, int(snap), _TYPE_CODES[x.dtype], vec,
        ctypes.c_float(int8_scale if snap else 0.0),
        ctypes.c_float(snap_reciprocal(int8_scale) if snap else 0.0))
    build.check(lib, rc, "e2softmax launch")
    e2softmax.launches += 1
    return out


def e2softmax(x: torch.Tensor, *, exp_bits: int = 4,
              int8_scale: Optional[float] = None,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """E2Softmax over the last axis of ``x`` (any leading dims); ``mask``
    (broadcastable to ``x``, True = keep) selects the masked variant, and
    is materialized at ``x``'s shape for the kernel. ``int8_scale`` snaps
    ``x - max`` to the int8 grid ``clip(round(d / s), -127, 0) * s``."""
    if not 0 <= exp_bits <= MAX_EXP_BITS:
        raise ValueError(f"exp_bits {exp_bits} outside [0, {MAX_EXP_BITS}]")
    if mask is not None:
        mask = torch.broadcast_to(mask, x.shape)
    if x.device.type == "cpu":
        return e2softmax_plain(x, exp_bits=exp_bits, int8_scale=int8_scale,
                               mask=mask)
    if x.device.type != "cuda":
        raise ValueError(f"no e2softmax kernel for device {x.device}")
    if mask is not None:
        mask = mask.contiguous()
    return _launch(x.contiguous(), mask, exp_bits=exp_bits,
                   int8_scale=int8_scale)


e2softmax.launches = 0
