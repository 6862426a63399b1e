"""Paged Flash-E2Softmax attention: the Hopper kernel
(``csrc/paged_e2softmax.cu``: one CTA per sequence, KV head and tile of
query rows serving the whole GQA group, bf16 on the tensor cores, float32
on the CUDA cores, :func:`paged_variant`), its wrappers and its plain
torch version.

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

The dense half (:func:`flash_e2softmax`, ``csrc/flash_e2softmax.cu``) is
the counterpart of ``flash_e2softmax_pallas`` (``_kernel``): q, k, v
(BH, S, d) -> (BH, S, d) float32, one online update per k-block of width
``block_k`` in order, with the Pallas kernel's padding and its
``block_q = block_k`` rule under ``causal``. bf16 inputs run on the
tensor cores, float32 ones on the CUDA cores (:func:`dense_variant`).

A wrapper given CPU tensors computes the plain version; given CUDA
tensors it launches the kernel or raises; given meta tensors it returns
what the kernel writes and reports its work to the cost counter
(``roofline/cost.py``).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from repro_torch.core.sole.e2softmax import ALDIV_BIAS, INV_LN2_SHIFT_APPROX
from repro_torch.kernels import build
from repro_torch.roofline.cost import (io_bytes, kernel_work,
                                       paged_attention_work, type_of)

NEG = -1e30
LOG2E = 1.4426950408889634
MAX_HEAD_DIM = 256
MAX_HEADS = 512             # query heads the paged kernel scans per CTA


def exp2_int(e: torch.Tensor) -> torch.Tensor:
    """Exact float32 ``2^e`` for int32 ``e`` in [-126, 127], built from
    the exponent bits (no transcendental rounding on any device)."""
    return ((e.to(torch.int32) + 127) << 23).view(torch.float32)


def pow2_neg(k: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 ``2^-k`` for integer ``k >= 0``: exact
    bits down to 2^-126, then one rounding into the subnormals (and 0 from
    2^-150 on)."""
    k = k.to(torch.int32)
    return (exp2_int(-torch.clamp_max(k, 126))
            * exp2_int(-torch.clamp(k - 126, 0, 30)))


@functools.lru_cache(maxsize=None)
def snap_reciprocal(int8_scale: float) -> float:
    """float32(1 / float32(s)) as a Python float (exact in float32, so a
    tensor times it rounds once, on any device, with no host copy). Inside
    ``jit`` XLA rewrites a division by the constant ``s`` into a multiply
    by this value."""
    one = torch.ones((), dtype=torch.float32)
    return float(one / torch.tensor(int8_scale, dtype=torch.float32))


@functools.lru_cache(maxsize=None)
def default_kv_head_map(h: int, kvh: int, device) -> torch.Tensor:
    """Contiguous GQA grouping ``h // (H // KV)`` (made once per device;
    callers do not write to it)."""
    return torch.arange(h, dtype=torch.int32, device=device) // max(h // kvh, 1)


PAGE = 16                   # tokens per page of the tensor-core kernel


def _pow2(x: float) -> bool:
    return math.frexp(float(torch.tensor(x, dtype=torch.float32)))[0] == 0.5


def paged_variant(q_dtype: torch.dtype, pool_dtype: torch.dtype, d: int,
                  bs: int, kv_scale: Optional[float] = None,
                  aligned: bool = True) -> str:
    """The paged kernel's instantiation for these arguments, as
    ``csrc/paged_e2softmax.cu``'s ``mma_variant`` picks it: bf16 q over bf16
    or int8 pools of 16-token pages (an int8 pool's ``kv_scale`` a power of
    two), ``d`` a multiple of 16, runs on the tensor cores at padded head
    dim 64 (``d <= 64`` with ``d^-1/2`` a power of two: 16, 64), 128 (``64 <
    d <= 128``: q scaled in float32 and split into three bf16 parts) or 256
    (``d = 256``); decode steps (C = 1) split each sequence's pages over
    warps and the CTAs of a cluster. Everything else (float32, 8-token
    pages, other head dims or scales) runs on the CUDA cores."""
    int8 = pool_dtype == torch.int8
    if (q_dtype == torch.bfloat16 and pool_dtype != torch.float32
            and bs == PAGE and d % 16 == 0 and aligned
            and (not int8 or (kv_scale is not None and _pow2(kv_scale)))
            and ((d <= 64 and _pow2(d ** -0.5)) or 64 < d <= 128
                 or d == 256)):
        return "bf16 mma.sync tensor cores"
    return "CUDA cores"


def flash_e2softmax_paged_plain(q, k_pool, v_pool, tables, meta, kv_head_map,
                                *, causal: bool, sole: bool, exp_bits: int,
                                int8_scale: Optional[float],
                                kv_scale: Optional[float] = None,
                                quant_pv: bool = False) -> torch.Tensor:
    """The kernel's function in plain torch: one online update per page,
    pages in table order, the whole batch at once (a page a sequence
    does not run leaves its state untouched). The int8 snap multiplies by
    ``float32(1 / s)``, as the jitted Pallas kernel does."""
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
                dm = torch.clamp(torch.round(dm * snap_reciprocal(int8_scale)),
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
    build.refuse_grad("flash_e2softmax_paged", q, k_pool, v_pool)
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
    if d > MAX_HEAD_DIM or h > MAX_HEADS:
        raise ValueError(f"head_dim {d} > {MAX_HEAD_DIM} or {h} > "
                         f"{MAX_HEADS} query heads")
    out = torch.empty((b, h, c, d), dtype=torch.float32, device=dev)
    if dev.type == "meta":
        # every page a table covers holds keys: the chunk ends there
        spans = [(nb * bs - c, nb * bs)] * b
        moved, ops = paged_attention_work(
            q.shape, q.element_size(), k_pool.element_size(), spans,
            causal=causal, kv_heads=kvh)
        kernel_work("paged_e2softmax", moved, {type_of(q.dtype): ops},
                    out.shape)
        return out
    lib = build.load("paged_e2softmax")
    fn = build.declare(lib, "paged_e2softmax", 7, 15, 4)
    vec = all(t.data_ptr() % 16 == 0 for t in (q, k_pool, v_pool))
    rc = build.launch(
        dev, fn, q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        tables.data_ptr(), meta.data_ptr(), kv_head_map.data_ptr(),
        out.data_ptr(), b, h, c, d, bs, kvh, nb, int(causal), int(sole),
        exp_bits, int(int8_scale is not None), _TYPE_CODES[q.dtype],
        _TYPE_CODES[pool_dtype], int(quant_pv), int(vec),
        ctypes.c_float(int8_scale or 0.0),
        ctypes.c_float(snap_reciprocal(int8_scale) if int8_scale
                       is not None else 0.0),
        ctypes.c_float(d ** -0.5), ctypes.c_float(kv_scale or 0.0))
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
    if q.device.type not in ("cuda", "meta"):
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


# -- dense Flash-E2Softmax ----------------------------------------------------

MAX_BLOCK = 128             # rows and keys per tile of the dense kernel
MAX_DENSE_HEAD_DIM = 128
MAX_EXP_BITS = 6            # codes and their exponents stay inside float32's


def dense_blocks(s: int, t: int, block_q: int, block_k: int,
                 causal: bool) -> Tuple[int, int]:
    """The Pallas kernel's tile sizes: each block clipped to its axis and,
    under ``causal``, both set to the smaller one."""
    bq, bk = min(block_q, s), min(block_k, t)
    if causal and bq != bk:
        bq = bk = min(bq, bk)
    return bq, bk


def flash_e2softmax_plain(q, k, v, *, causal: bool = True, sole: bool = True,
                          exp_bits: int = 4,
                          int8_scale: Optional[float] = None,
                          block_q: int = 128, block_k: int = 128,
                          exact_corr: bool = False) -> torch.Tensor:
    """The dense kernel's function in plain torch: every q row at once,
    one online update per k-block in order. A causal k-block that no row
    of a q tile reaches is skipped by the kernel; for those rows the
    update is the identity (corr = 1, w = 0), so running it here is the
    same. The int8 snap multiplies by ``float32(1 / s)``, as the jitted
    Pallas kernel does."""
    bh, s, d = q.shape
    t = k.shape[1]
    _, bk = dense_blocks(s, t, block_q, block_k, causal)
    dev = q.device
    qf = q.float() * (d ** -0.5)
    rows = torch.arange(s, device=dev)[:, None]
    m = torch.full((bh, s), NEG, dtype=torch.float32, device=dev)
    ssum = torch.zeros((bh, s), dtype=torch.float32, device=dev)
    acc = torch.zeros((bh, s, d), dtype=torch.float32, device=dev)
    kmax, submax = 2 ** exp_bits - 1, 2 ** (exp_bits + 2) - 1
    for c0 in range(0, t, bk):
        kb = k[:, c0:c0 + bk].float()
        vb = v[:, c0:c0 + bk].float()
        cols = c0 + torch.arange(kb.shape[1], device=dev)[None, :]
        mask = cols < t
        if causal:
            mask = mask & (rows >= cols)
        logits = torch.where(mask, torch.einsum("bsd,btd->bst", qf, kb), NEG)
        m_new = torch.maximum(m, logits.amax(-1))
        dm = logits - m_new[..., None]
        if sole:
            if int8_scale is not None:
                dm = torch.clamp(torch.round(dm * snap_reciprocal(int8_scale)),
                                 -127, 0) * int8_scale
            kc = torch.clamp(torch.round(-dm * INV_LN2_SHIFT_APPROX), 0, kmax)
            w = torch.where(mask, exp2_int(-kc), 0.0)
            if exact_corr:
                corr = torch.exp2((m - m_new) * LOG2E)
            else:
                corr = pow2_neg(torch.clamp(torch.round(
                    (m_new - m) * INV_LN2_SHIFT_APPROX), 0, submax))
        else:
            w = torch.where(mask, torch.exp2(dm * LOG2E), 0.0)
            corr = torch.exp2((m - m_new) * LOG2E)
        ssum = ssum * corr + w.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bst,btd->bsd", w, vb)
        m = m_new
    ssum = torch.clamp_min(ssum, 2.0 ** -30)
    if sole:
        mant, expo = torch.frexp(ssum)
        factor = torch.where(mant >= 0.75, ALDIV_BIAS - 0.5, ALDIV_BIAS)
        scale = factor.float() * exp2_int(-expo)
    else:
        scale = torch.ones_like(ssum) / ssum
    return acc * scale[..., None]


def dense_variant(dtype: torch.dtype) -> str:
    """The dense kernel's instantiation for q/k/v of ``dtype``: bf16 runs
    on the tensor cores, float32 on the CUDA cores."""
    if dtype == torch.bfloat16:
        return "bf16 mma.sync tensor cores"
    if dtype == torch.float32:
        return "float32 CUDA cores"
    raise TypeError(f"q dtype {dtype}: the kernel takes float32 or bfloat16")


def _launch_dense(q, k, v, *, causal, sole, exp_bits, int8_scale, bq, bk,
                  exact_corr) -> torch.Tensor:
    build.refuse_grad("flash_e2softmax", q, k, v)
    bh, s, d = q.shape
    t = k.shape[1]
    dev = q.device
    dense_variant(q.dtype)
    _check(q, "q", q.dtype, 3, dev)
    _check(k, "k", q.dtype, 3, dev)
    _check(v, "v", q.dtype, 3, dev)
    if k.shape[0] != bh or k.shape[2] != d or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if d > MAX_DENSE_HEAD_DIM or bh >= 2 ** 16:
        raise ValueError(f"head_dim {d} > {MAX_DENSE_HEAD_DIM} or "
                         f"{bh} >= 65536 heads")
    out = torch.empty((bh, s, d), dtype=torch.float32, device=dev)
    if bh == 0 or s == 0:
        return out
    if dev.type == "meta":
        # row r sees keys 0..r under causal: sum of min(t, r + 1)
        m = min(s, t)
        pairs = m * (m + 1) // 2 + (s - m) * t if causal else s * t
        kernel_work("flash_e2softmax", io_bytes(q, k, v, out),
                    {type_of(q.dtype): 4 * d * pairs * bh}, out.shape)
        return out
    lib = build.load("flash_e2softmax")
    fn = build.declare(lib, "flash_e2softmax", 4, 12, 3)
    snap = int8_scale is not None
    rc = build.launch(
        dev, fn, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh,
        s, t, d, bq, bk, int(causal), int(sole), exp_bits, int(snap),
        int(exact_corr), _TYPE_CODES[q.dtype],
        ctypes.c_float(int8_scale if snap else 0.0),
        ctypes.c_float(snap_reciprocal(int8_scale) if snap else 0.0),
        ctypes.c_float(d ** -0.5))
    build.check(lib, rc, "flash_e2softmax launch")
    flash_e2softmax.launches += 1
    return out


def flash_e2softmax(q, k, v, *, causal: bool = True, sole: bool = True,
                    exp_bits: int = 4, int8_scale: Optional[float] = None,
                    block_q: int = 128, block_k: int = 128,
                    exact_corr: bool = False) -> torch.Tensor:
    """Dense fused attention, single-head layout: q (BH, S, d), k/v
    (BH, T, d) -> (BH, S, d) float32. SOLE mode streams 4-bit log2 codes
    with the quantized (or, ``exact_corr``, float32) correction per
    k-block and ALDivision at the end; exact mode is the online softmax.
    Tiles of more than ``MAX_BLOCK`` rows or keys raise."""
    if not 0 <= exp_bits <= MAX_EXP_BITS:
        raise ValueError(f"exp_bits {exp_bits} outside [0, {MAX_EXP_BITS}]")
    s, t = q.shape[1], k.shape[1]
    if t == 0:
        raise ValueError("attention over zero keys")
    bq, bk = dense_blocks(s, t, block_q, block_k, causal)
    if max(bq, bk) > MAX_BLOCK:
        raise ValueError(f"tiles {bq} x {bk}: the kernel takes 1 to "
                         f"{MAX_BLOCK} rows and keys")
    kw = dict(causal=causal, sole=sole, exp_bits=exp_bits,
              int8_scale=int8_scale, exact_corr=exact_corr)
    if q.device.type == "cpu":
        return flash_e2softmax_plain(q, k, v, block_q=block_q,
                                     block_k=block_k, **kw)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"no flash_e2softmax kernel for device {q.device}")
    return _launch_dense(q.contiguous(), k.contiguous(), v.contiguous(),
                         bq=bq, bk=bk, **kw)


flash_e2softmax.launches = 0
