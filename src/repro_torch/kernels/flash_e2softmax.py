"""Paged Flash-E2Softmax attention: the Hopper kernel
(``csrc/paged_e2softmax.cu``), its wrappers and its plain torch version.

Counterpart of ``repro/kernels/flash_e2softmax.py``'s paged entry points
(``_paged_kernel`` via ``flash_e2softmax_paged`` /
``flash_e2softmax_paged_decode``), in the same layouts: q (B, H, C, d),
pools (N, bs, KV, d), tables (B, NB) int32, meta (B, 2) int32 rows
(q_start, kv_len), optional kv_head_map (H,) int32; output
(B, H, C, d) float32.

Pools may hold int8 codes with one scale ``kv_scale`` (the W8A8 path):
K is dequantized page by page in float32, and so is V unless
``quant_pv``, where P.V accumulates the raw V codes and ``kv_scale``
multiplies the final row scale (exact: it is a power of two).

A wrapper given CPU tensors computes the plain version; given CUDA
tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.sole.e2softmax import ALDIV_BIAS, INV_LN2_SHIFT_APPROX
from repro_torch.core.sole.quant import true_div
from repro_torch.kernels import build

NEG = -1e30
LOG2E = 1.4426950408889634
MAX_HEAD_DIM = 256


def exp2_int(e: torch.Tensor) -> torch.Tensor:
    """Exact float32 ``2^e`` for int32 ``e`` in [-126, 127], built from
    the exponent bits (no transcendental rounding on any device)."""
    return ((e.to(torch.int32) + 127) << 23).view(torch.float32)


def default_kv_head_map(h: int, kvh: int, device) -> torch.Tensor:
    """Contiguous GQA grouping ``h // (H // KV)``."""
    return torch.arange(h, dtype=torch.int32, device=device) // max(h // kvh, 1)


def flash_e2softmax_paged_plain(q, k_pool, v_pool, tables, meta, kv_head_map,
                                *, causal: bool, sole: bool, exp_bits: int,
                                int8_scale: Optional[float],
                                kv_scale: Optional[float] = None,
                                quant_pv: bool = False) -> torch.Tensor:
    """The kernel's function in plain torch: one online update per page,
    pages in table order, the whole batch at once (a page a sequence
    does not run leaves its state untouched)."""
    b, h, c, d = q.shape
    bs = k_pool.shape[1]
    nb = tables.shape[1]
    dev = q.device
    tables = tables.long()
    kvmap = kv_head_map.long()
    qf = q.float() * (d ** -0.5)
    q_start, kv_len = meta[:, 0].long(), meta[:, 1].long()
    rows = q_start[:, None] + torch.arange(c, device=dev)          # (B, C)
    m = torch.full((b, h, c), NEG, dtype=torch.float32, device=dev)
    s = torch.zeros((b, h, c), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, h, c, d), dtype=torch.float32, device=dev)
    kmax, submax = 2 ** exp_bits - 1, 2 ** (exp_bits + 2) - 1
    for j in range(nb):
        run = j * bs < kv_len
        if causal:
            run = run & (j * bs <= q_start + c - 1)
        pages = tables[:, j]
        k = k_pool[pages][:, :, kvmap].float()                      # (B,bs,H,d)
        v = v_pool[pages][:, :, kvmap].float()
        if kv_scale is not None:                    # int8 page pools
            k = k * kv_scale
            if not quant_pv:
                v = v * kv_scale
        logits = torch.einsum("bhcd,bthd->bhct", qf, k)
        cols = j * bs + torch.arange(bs, device=dev)
        mask = (cols[None, :] < kv_len[:, None])[:, None, None, :]  # (B,1,1,bs)
        if causal:
            mask = mask & (rows[:, :, None] >= cols)[:, None]       # (B,1,C,bs)
        logits = torch.where(mask, logits, NEG)
        m_new = torch.maximum(m, logits.amax(-1))
        dm = logits - m_new[..., None]
        if sole:
            if int8_scale is not None:
                dm = torch.clamp(torch.round(true_div(dm, int8_scale)),
                                 -127, 0) * int8_scale
            kc = torch.clamp(torch.round(-dm * INV_LN2_SHIFT_APPROX), 0, kmax)
            w = torch.where(mask, exp2_int(-kc), 0.0)
            sub = torch.clamp(torch.round((m_new - m) * INV_LN2_SHIFT_APPROX),
                              0, submax)
            corr = exp2_int(-sub)
        else:
            w = torch.where(mask, torch.exp2(dm * LOG2E), 0.0)
            corr = torch.exp2((m - m_new) * LOG2E)
        s_new = s * corr + w.sum(-1)
        acc_new = acc * corr[..., None] + torch.einsum("bhct,bthd->bhcd", w, v)
        live = run[:, None, None]
        m = torch.where(live, m_new, m)
        s = torch.where(live, s_new, s)
        acc = torch.where(live[..., None], acc_new, acc)
    s = torch.clamp_min(s, 2.0 ** -30)
    if sole:
        mant, expo = torch.frexp(s)
        factor = torch.where(mant >= 0.75, ALDIV_BIAS - 0.5, ALDIV_BIAS)
        scale = factor.float() * exp2_int(-expo)
    else:
        scale = torch.ones_like(s) / s
    if quant_pv and kv_scale is not None:
        scale = scale * kv_scale
    return acc * scale[..., None]


def _check(t: torch.Tensor, name: str, dtype, ndim: int, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{ndim} dims")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


# element type codes of the kernel's C interface
_TYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def _launch(q, k_pool, v_pool, tables, meta, kv_head_map, *, causal, sole,
            exp_bits, int8_scale, kv_scale, quant_pv) -> torch.Tensor:
    b, h, c, d = q.shape
    n, bs, kvh, dk = k_pool.shape
    nb = tables.shape[1]
    dev = q.device
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q dtype {q.dtype}: the kernel takes float32 or "
                        "bfloat16")
    pool_dtype = torch.int8 if kv_scale is not None else q.dtype
    _check(q, "q", q.dtype, 4, dev)
    _check(k_pool, "k_pool", pool_dtype, 4, dev)
    _check(v_pool, "v_pool", pool_dtype, 4, dev)
    _check(tables, "tables", torch.int32, 2, dev)
    _check(meta, "meta", torch.int32, 2, dev)
    _check(kv_head_map, "kv_head_map", torch.int32, 1, dev)
    if (dk != d or tuple(v_pool.shape) != tuple(k_pool.shape)
            or tables.shape[0] != b or tuple(meta.shape) != (b, 2)
            or kv_head_map.shape[0] != h):
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)}, pools {tuple(k_pool.shape)}"
            f"/{tuple(v_pool.shape)}, tables {tuple(tables.shape)}, meta "
            f"{tuple(meta.shape)}, kv_head_map {tuple(kv_head_map.shape)}")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d} > {MAX_HEAD_DIM}")
    out = torch.empty((b, h, c, d), dtype=torch.float32, device=dev)
    lib = build.load("paged_e2softmax")
    fn = build.declare(lib, "paged_e2softmax", 7, 14, 3)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                tables.data_ptr(), meta.data_ptr(), kv_head_map.data_ptr(),
                out.data_ptr(), b, h, c, d, bs, kvh, nb, int(causal),
                int(sole), exp_bits, int(int8_scale is not None),
                _TYPE_CODES[q.dtype], _TYPE_CODES[pool_dtype], int(quant_pv),
                ctypes.c_float(int8_scale or 0.0), ctypes.c_float(d ** -0.5),
                ctypes.c_float(kv_scale or 0.0), ctypes.c_void_p(stream))
    build.check(lib, rc, "paged_e2softmax launch")
    flash_e2softmax_paged.launches += 1
    return out


def flash_e2softmax_paged(q, k_pool, v_pool, tables, meta, *,
                          kv_head_map=None, causal: bool = True,
                          sole: bool = True, exp_bits: int = 4,
                          int8_scale: Optional[float] = None,
                          kv_scale: Optional[float] = None,
                          quant_pv: bool = False) -> torch.Tensor:
    """Fused attention over a block-paged KV pool (see module docstring);
    ``kv_len`` counts the chunk's own keys, written before the call.
    ``kv_scale`` marks int8 pools; without it ``quant_pv`` does nothing,
    as in the reference."""
    if kv_head_map is None:
        kv_head_map = default_kv_head_map(q.shape[1], k_pool.shape[2],
                                          q.device)
    kw = dict(causal=causal, sole=sole, exp_bits=exp_bits,
              int8_scale=int8_scale, kv_scale=kv_scale, quant_pv=quant_pv)
    if q.device.type == "cpu":
        return flash_e2softmax_paged_plain(q, k_pool, v_pool, tables, meta,
                                           kv_head_map, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"no paged_e2softmax for device {q.device}")
    return _launch(q, k_pool, v_pool, tables, meta, kv_head_map, **kw)


flash_e2softmax_paged.launches = 0


def flash_e2softmax_paged_decode(q, k_pool, v_pool, tables, ctx_lens, *,
                                 kv_head_map=None, sole: bool = True,
                                 exp_bits: int = 4,
                                 int8_scale: Optional[float] = None,
                                 kv_scale: Optional[float] = None,
                                 quant_pv: bool = False) -> torch.Tensor:
    """Single-query decode over the paged pool: q (B, H, d), ctx_lens
    (B,) valid keys including the current token -> (B, H, d) float32."""
    meta = torch.stack([torch.zeros_like(ctx_lens, dtype=torch.int32),
                        ctx_lens.to(torch.int32)], 1)
    out = flash_e2softmax_paged(
        q[:, :, None].contiguous(), k_pool, v_pool, tables, meta,
        causal=False, kv_head_map=kv_head_map, sole=sole, exp_bits=exp_bits,
        int8_scale=int8_scale, kv_scale=kv_scale, quant_pv=quant_pv)
    return out[:, :, 0]
