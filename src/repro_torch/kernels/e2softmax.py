"""E2Softmax over the last axis: the Hopper kernel (``csrc/e2softmax.cu``),
its wrapper and its plain torch version.

Counterpart of ``repro/kernels/e2softmax.py``'s ``_kernel`` and
``_masked_kernel`` (entry point ``e2softmax_pallas``): max, optional int8
snap of ``x - max``, 4-bit log2 codes ``k``, ``S = sum 2^-k``, ALDivision
``2^-(k + e) * {1.636, 1.136}``; the snap multiplies by ``float32(1/s)``,
as the jitted Pallas call does (XLA rewrites its division by the static
scale); with a mask (True = keep) masked entries
give exactly 0 and a fully masked row gives a row of zeros. Logits are
float32 or bf16 with any leading dims; the output is float32 or bf16
(``out_dtype``, the float32 result rounded once). The kernel reads the
logits and the mask as strided views, so a mask broadcast over heads or
lanes is never copied.

:func:`e2softmax` given CPU tensors computes the plain version; given CUDA
tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.core.sole.e2softmax import ALDIV_BIAS, INV_LN2_SHIFT_APPROX
from repro_torch.kernels import build
from repro_torch.roofline.cost import (E2_OPS_PER_ELEMENT, distinct_bytes,
                                       io_bytes, kernel_work)
from repro_torch.kernels.flash_e2softmax import (MAX_EXP_BITS, exp2_int,
                                                 snap_reciprocal)

_TYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_VEC = {torch.float32: 4, torch.bfloat16: 8}     # elements per 16-byte load
_LEAD_DIMS = 4                                   # leading dims the kernel indexes


def e2softmax_plain(x, *, exp_bits: int = 4,
                    int8_scale: Optional[float] = None,
                    mask: Optional[torch.Tensor] = None,
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The kernel's arithmetic in plain torch, in the same order, on any
    device: ``x`` (..., C) -> (..., C) in ``out_dtype`` (the float32 result
    rounded once); ``mask`` broadcastable to ``x``, bool or uint8
    (non-zero = keep)."""
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
    return out.to(out_dtype)


def row_view(x: torch.Tensor, mask: Optional[torch.Tensor]):
    """The kernel's view of ``x`` (..., C) and of ``mask`` (x's shape, any
    strides): ``(sizes, x_strides, mask_strides)``, each of four leading
    dims (outermost first; element strides, 0 where the mask broadcasts),
    after dropping size-1 dims and merging neighbours both views walk
    evenly. None when the views need more than four leading dims or a
    column stride other than 1."""
    return _row_view(tuple(x.shape), x.stride(),
                     None if mask is None else mask.stride())


@functools.lru_cache(maxsize=1024)
def _row_view(shape, xs, ms):
    c = shape[-1]
    if c > 1 and (xs[-1] != 1 or (ms is not None and ms[-1] != 1)):
        return None
    ms = ms or (0,) * len(shape)
    dims = []
    for n, a, b in zip(shape[:-1], xs[:-1], ms[:-1]):
        if n == 1:
            continue
        if dims and dims[-1][1] == a * n and dims[-1][2] == b * n:
            dims[-1] = (dims[-1][0] * n, a, b)
        else:
            dims.append((n, a, b))
    if len(dims) > _LEAD_DIMS:
        return None
    dims = [(1, 0, 0)] * (_LEAD_DIMS - len(dims)) + dims
    return tuple(tuple(d[i] for d in dims) for i in range(3))


@functools.lru_cache(maxsize=1024)
def _launch_ints(shape, xs, ms, n: int):
    """The launcher's view arguments ``(n1, n2, n3, x strides, mask
    strides)`` and whether every stride is a multiple of the vector
    width ``n``; None where :func:`_row_view` has no view."""
    view = _row_view(shape, xs, ms)
    if view is None:
        return None
    sizes, xst, mst = view
    if any(abs(v) >= 2 ** 31 for v in xst + mst):
        raise ValueError(f"strides {xst} / {mst}: the kernel takes fewer "
                         "than 2^31")
    return sizes[1:] + xst + mst, all(v % n == 0 for v in xst + mst)


def _launch(x, mask, *, exp_bits, int8_scale, out_dtype) -> torch.Tensor:
    build.refuse_grad("e2softmax", x)
    if x.dtype not in _TYPE_CODES:
        raise TypeError(f"x dtype {x.dtype}: the kernel takes float32 or "
                        "bfloat16")
    if out_dtype not in _TYPE_CODES:
        raise TypeError(f"out_dtype {out_dtype}: the kernel writes float32 "
                        "or bfloat16")
    if mask is not None:
        if mask.get_device() != x.get_device():
            raise ValueError(f"mask is on {mask.device}, x on {x.device}")
        if mask.dtype not in (torch.bool, torch.uint8):
            raise TypeError(f"mask dtype {mask.dtype}: need bool or uint8")
    n = _VEC[x.dtype]
    shape = tuple(x.shape)
    ms = None if mask is None else mask.stride()
    view = _launch_ints(shape, x.stride(), ms, n)
    if view is None and _row_view(shape, x.stride(), None) is None:
        x = x.contiguous()            # x alone is no view: its rows packed
        view = _launch_ints(shape, x.stride(), ms, n)
    if view is None:
        raise ValueError(
            f"mask of shape {tuple(mask.shape)} and strides {mask.stride()} "
            f"over x {shape} {x.stride()}: the kernel reads views of at most "
            f"{_LEAD_DIMS} leading dims with unit column stride")
    ints, strides_vec = view
    c = shape[-1]
    rows = x.numel() // max(c, 1)
    out = torch.empty(shape, dtype=out_dtype, device=x.device)
    if rows == 0 or c == 0:
        return out
    if rows >= 2 ** 31:
        raise ValueError(f"{rows} rows: the kernel takes fewer than 2^31")
    if x.device.type == "meta":
        kernel_work("e2softmax", io_bytes(x, out) + (
            0 if mask is None else distinct_bytes(mask)),
            {"float32": E2_OPS_PER_ELEMENT * x.numel()}, out.shape)
        return out
    vec = int(strides_vec and c % n == 0 and x.data_ptr() % 16 == 0
              and out.data_ptr() % 16 == 0
              and (mask is None or mask.data_ptr() % n == 0))
    lib = build.load("e2softmax")
    fn = build.declare(lib, "e2softmax", 3, 18, 2)
    snap = int8_scale is not None
    rc = build.launch(
        x.device, fn, x.data_ptr(), None if mask is None else mask.data_ptr(),
        out.data_ptr(), rows, c, exp_bits, int(snap), _TYPE_CODES[x.dtype],
        _TYPE_CODES[out_dtype], vec, *ints,
        ctypes.c_float(int8_scale if snap else 0.0),
        ctypes.c_float(snap_reciprocal(int8_scale) if snap else 0.0))
    build.check(lib, rc, "e2softmax launch")
    e2softmax.launches += 1
    return out


def e2softmax(x: torch.Tensor, *, exp_bits: int = 4,
              int8_scale: Optional[float] = None,
              mask: Optional[torch.Tensor] = None,
              out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """E2Softmax over the last axis of ``x`` (any leading dims); ``mask``
    (broadcastable to ``x``, True = keep) selects the masked variant and
    is read in place through its strides (a mask the kernel's view cannot
    express raises). ``int8_scale`` snaps ``x - max`` to the int8 grid
    ``clip(round(d / s), -127, 0) * s``; ``out_dtype`` (float32 or bf16)
    is the type the output is written in."""
    if not 0 <= exp_bits <= MAX_EXP_BITS:
        raise ValueError(f"exp_bits {exp_bits} outside [0, {MAX_EXP_BITS}]")
    if mask is not None and mask.shape != x.shape:
        mask = torch.broadcast_to(mask, x.shape)
    if x.device.type == "cpu":
        return e2softmax_plain(x, exp_bits=exp_bits, int8_scale=int8_scale,
                               mask=mask, out_dtype=out_dtype)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"no e2softmax kernel for device {x.device}")
    return _launch(x, mask, exp_bits=exp_bits, int8_scale=int8_scale,
                   out_dtype=out_dtype)


e2softmax.launches = 0
