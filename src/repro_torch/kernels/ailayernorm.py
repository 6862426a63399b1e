"""AILayerNorm / AIRMSNorm: the Hopper kernels (``csrc/ailayernorm.cu``),
their wrappers and their plain torch versions.

Counterpart of ``repro/kernels/ailayernorm.py``. The three static-params
entries are one team-per-row kernel template; each takes the PTF params'
``scale`` (one element, float32 or bf16) and per-channel ``alpha``, forms
``denom = scale * 2^alpha`` itself, and reads float32 or bf16 rows:

* :func:`qnorm` (``_qnorm_kernel``): PTF quantize + integer statistics +
  affine of each row. :func:`ailayernorm`/:func:`airmsnorm` reach it with
  the caller's static params.
* :func:`add_norm` (``_fused_kernel``): ``h = x + r`` written out in
  float32, then the same body on ``h`` in one pass —
  :func:`fused_add_norm` with static params.
* :func:`add_norm_quant` (``_fused_q_kernel``): the above plus per-row
  symmetric int8 of the normalized row — :func:`fused_add_norm_quant`
  with static params. Its codes and scale equal ``quantize_act`` of
  :func:`add_norm`'s output bit for bit.
* :func:`codes_norm` (``_kernel``, ``ailayernorm_pallas_codes``): the
  statistics and LayerNorm affine on centred int32 codes —
  :func:`ailayernorm_codes`.
* :func:`calibrated_norm`: the ``params=None`` chain of the serve path —
  the residual add, ``calibrate_ptf`` over all rows and the quantize+norm
  (``_qnorm_kernel``), with the output in the model dtype or as per-row
  int8 — in one launch, laid out by :func:`calib_plan`: one
  thread-block cluster for decode and verify rows, a cooperative grid over
  the card for prefill rows.
  :func:`ailayernorm`/:func:`airmsnorm`/:func:`fused_add_norm`/
  :func:`fused_add_norm_quant` without params reach it.
* :func:`calibrated_norm_split`: the same chain on a share of the batch's
  rows (the mesh's data axis splits a dispatch's lanes), calibrated over
  the whole batch through a max all-reduce of the per-channel maxima: the
  add and the maxima as torch ops, as the reference computes them in XLA
  outside its Pallas kernel (``repro/kernels/ailayernorm.py:305-359``),
  then :func:`qnorm` (or :func:`add_norm_quant` for int8 out) with the
  PTF params the whole batch's maxima give. Bitwise the rows the
  calibrating norm gives on the whole batch.
* :func:`exact_norm`: the exact mode's float LayerNorm / RMSNorm (no TPU
  kernel: XLA's reduction there). A team of threads per row, its size
  chosen by C alone (:func:`exact_team`), holds the row in registers,
  loaded with 16-byte loads before the first add, in a reduction order
  fixed by C, so a row's bits do not depend on the rows beside it; its
  plain version is the reference backend's torch ops. It is
  differentiable: a ``torch.autograd.Function`` whose backward,
  :func:`exact_norm_backward`, is a hand-written kernel too
  (``exact_norm_bwd_kernel``: x and dy read once into the forward's
  teams, the forward's mu/inv, dx and the dgamma/dbeta partials in one
  pass over row ranges fixed by :func:`bwd_plan`; then
  ``exact_norm_wgrad_kernel`` sums the partials in order; no atomics);
  its plain version is autograd through :func:`exact_norm_plain`.

Each wrapper given CPU tensors computes the plain version; given CUDA
tensors it launches its kernel or raises; given meta tensors it returns
what the kernel writes and reports its work to the cost counter
(``roofline/cost.py``). The SOLE kernels have no
backward: on CUDA tensors they raise where grad mode is on and an input
requires grad (``build.refuse_grad``), so a graph is never cut silently. A static-params op call on
contiguous float32 or bf16 activations on the card is one kernel launch:
no cast of the rows, no ``denom()``, no zero beta and no cast of the
output, which the kernel writes in float32 or the activations' type.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core.sole.ailayernorm import (compressed_square, inv_sqrt,
                                               ptf_shift)
from repro_torch.core.sole.quant import (PTFQuantParams, calibrate_ptf,
                                         ptf_denom, quantize_act)
from repro_torch.kernels import build
from repro_torch.roofline.cost import (EXACT_NORM_BWD_OPS_PER_ELEMENT,
                                       EXACT_NORM_OPS_PER_ELEMENT,
                                       QNORM_OPS_PER_ELEMENT, io_bytes,
                                       kernel_work)

# shared memory holds one row of int32 codes (48 KB without opt-in)
MAX_CHANNELS = 12288


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 ``a * b + c`` (one rounding, as a fused
    multiply-add), on any device. The float64 product is exact; the float64
    sum and the cast to float32 round twice, which differs from one rounding
    only where the sum lands exactly on a float32 midpoint while the exact
    value does not: there the TwoSum error term says which neighbour the
    exact value is nearer to."""
    a, b, c = torch.broadcast_tensors(a.double(), b.double(), c.double())
    p = a * b
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)                 # s + err == p + c exactly
    r = s.float()
    r64 = r.double()
    above = s > r64
    nb = torch.nextafter(r, torch.where(above, torch.full_like(r, torch.inf),
                                        torch.full_like(r, -torch.inf)))
    mid = (s != r64) & ((r64 + nb.double()) * 0.5 == s)
    lo = torch.where(above, r, nb)
    hi = torch.where(above, nb, r)
    return torch.where(mid & (err > 0), hi, torch.where(mid & (err < 0), lo, r))


@functools.lru_cache(maxsize=None)
def inv_channels(c: int) -> float:
    """float32(1 / C) as a Python float: inside ``jit`` XLA turns the
    reference's ``/ C`` into a multiply by it (and ``* 16 / C`` into one by
    ``16 * float32(1 / C)``, exactly ``float32(16 / C)``)."""
    return float(torch.ones((), dtype=torch.float32)
                 / torch.tensor(float(c), dtype=torch.float32))


def row_stats(xi, alpha, *, rms: bool):
    """``(xs, mu, var)`` of int32 codes ``xi`` (rows, C): the PTF-shifted
    codes, the mean (None for RMS) and the clamped variance (mean square
    for RMS) whose ``1/sqrt`` the affine takes, in the compiled reference's
    forms: its divisions by C are multiplies by ``float32(1/C)`` and
    ``float32(16/C)``, and LLVM contracts the LayerNorm variance
    ``ex2 * (16/C) - mu * mu`` into one fused multiply-add."""
    inv_c = inv_channels(xi.shape[-1])
    sq = compressed_square(xi.abs())
    xs = ptf_shift(xi, alpha)
    ex2 = (sq << (2 * alpha)).sum(-1, keepdim=True, dtype=torch.int32).float()
    if rms:
        return xs, None, torch.clamp_min(ex2 * (16.0 * inv_c), 1.0)
    mu = xs.sum(-1, keepdim=True, dtype=torch.int32).float() * inv_c
    var = fma32(ex2, torch.full_like(ex2, 16.0 * inv_c), -(mu * mu))
    return xs, mu, torch.clamp_min(var, 1.0)


def grouped_rows(x: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    """``x`` (..., C) as (rows / G, G, C) for a (G, C) affine, under which
    row r takes gamma/beta row r mod G (rwkv6's per-head GroupNorm: G
    heads of C channels); ``x`` itself for a (C,) affine."""
    if gamma.ndim == 1:
        return x
    g, c = gamma.shape
    rows = x.numel() // c if c else 0
    if x.shape[-1] != c or rows % g:
        raise ValueError(f"a ({g}, {c}) affine needs rows of {c} channels in "
                         f"a multiple of {g}, got {tuple(x.shape)}")
    return x.reshape(-1, g, c)


def _norm_codes_plain(xi, alpha, gamma, beta, *, rms: bool) -> torch.Tensor:
    """The row body from int32 codes on, in the kernel's order. The
    LayerNorm affine is one fused multiply-add, as LLVM contracts the
    compiled reference's ``(gamma * rs) * (xs - mu) + beta``; a None
    ``beta`` is a zero shift. ``gamma``/``beta`` (C,), or (G, C) with row
    r taking row r mod G."""
    shape = xi.shape
    xi = grouped_rows(xi, gamma)
    xs, mu, var = row_stats(xi, alpha, rms=rms)
    rs = inv_sqrt(var)
    if rms:
        return (gamma * xs.float() * rs).reshape(shape)
    if beta is None:
        beta = torch.zeros_like(gamma)
    return fma32(gamma * rs, xs.float() - mu, beta).reshape(shape)


def ptf_codes(x, denom) -> torch.Tensor:
    """Centred PTF codes ``clip(round(x / denom), -128, 127)`` as int32
    (the unsigned codes minus their zero point, or the symmetric ones)."""
    return torch.clamp(torch.round(x / denom), -128, 127).to(torch.int32)


def qnorm_plain(x, scale, alpha, gamma, beta=None, *, rms: bool,
                out_dtype=torch.float32) -> torch.Tensor:
    """The kernel's arithmetic in plain torch, in the same order: (rows,
    C) activations, read as float32, with the PTF ``scale`` and ``alpha``
    (C,) -> (rows, C) in ``out_dtype``. ``denom`` is ``ptf_denom``'s, which
    the kernels' multiply by the exact ``2^alpha`` equals bit for bit."""
    out = _norm_codes_plain(ptf_codes(x.float(), ptf_denom(scale, alpha)),
                            alpha, gamma, beta, rms=rms)
    return out.to(out_dtype)


def add_norm_plain(x, r, scale, alpha, gamma, beta=None, *, rms: bool,
                   out_dtype=torch.float32
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(h, qnorm(h))`` with ``h = x + r`` in float32."""
    h = x.float() + r.float()
    return h, qnorm_plain(h, scale, alpha, gamma, beta, rms=rms,
                          out_dtype=out_dtype)


def add_norm_quant_plain(x, r, scale, alpha, gamma, beta=None, *,
                         rms: bool):
    """``(h, int8 codes, (rows, 1) scale)``: :func:`add_norm_plain`, then
    ``quantize_act`` of the norm."""
    h, out = add_norm_plain(x, r, scale, alpha, gamma, beta, rms=rms)
    codes, qscale = quantize_act(out)
    return h, codes, qscale


def codes_norm_plain(xi, alpha, gamma, beta) -> torch.Tensor:
    """LayerNorm of centred int32 codes (rows, C) -> float32."""
    return _norm_codes_plain(xi, alpha, gamma, beta, rms=False)


# activation types the kernels read (and write)
_ACT_TYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check_row_args(rows_in, c: int, **args) -> None:
    """Raise unless ``rows_in`` is (rows, C <= MAX_CHANNELS) on the card
    and every tensor of ``args`` (name -> (tensor, dtype, shape)) is
    contiguous, of its dtype and shape and on the same device."""
    dev = rows_in.device
    if dev.type not in ("cuda", "meta"):
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


def _chan(alpha, gamma, beta, c: int) -> dict:
    f32 = torch.float32
    out = dict(alpha=(alpha, torch.int32, (c,)), gamma=(gamma, f32, (c,)))
    if beta is not None:
        out["beta"] = (beta, f32, (c,))
    return out


def _static_launch(wrapper, x, r, scale, alpha, gamma, beta, *, rms: bool,
                   out_dtype=None, quant: bool = False):
    """Check the arguments of a static-params entry, launch it and count
    the launch on ``wrapper``: ``x`` (rows, C) float32 or bf16, ``r``
    alike or None, ``scale`` one element (float32 or bf16 read as it is,
    another type cast), ``alpha`` (C,) int32, ``gamma``/``beta`` (C,)
    float32 (``beta`` None: a zero shift). Returns ``(h or None, out)``,
    ``out`` in ``out_dtype`` (float32 or bf16), or ``(h, (codes, (rows, 1)
    scale))`` with ``quant``."""
    build.refuse_grad(f"ailayernorm {wrapper.__name__}", x, r, scale, alpha,
                      gamma, beta)
    if x.device.type != "cpu" and x.dtype not in _ACT_TYPES:
        raise TypeError(f"x dtype {x.dtype}: the kernel reads float32 or "
                        "bfloat16 rows")
    rows, c = x.shape[0], x.shape[-1]
    args = dict(x=(x, x.dtype, (rows, c)), **_chan(alpha, gamma, beta, c))
    if r is not None:
        args["r"] = (r, x.dtype, (rows, c))
    _check_row_args(x, c, **args)
    if scale.numel() != 1 or scale.device != x.device:
        raise ValueError(f"scale: need one element on {x.device}, got "
                         f"{tuple(scale.shape)} on {scale.device}")
    if scale.dtype not in _ACT_TYPES:
        scale = scale.float()        # as PTFQuantParams.denom() rounds it
    if out_dtype not in (None, torch.float32, torch.bfloat16):
        raise TypeError(f"out_dtype {out_dtype}: float32 or bfloat16")
    dev = x.device
    h = None if r is None else torch.empty((rows, c), dtype=torch.float32,
                                           device=dev)
    out = codes = qscale = None
    if quant:
        codes = torch.empty((rows, c), dtype=torch.int8, device=dev)
        qscale = torch.empty((rows, 1), dtype=torch.float32, device=dev)
        res = (codes, qscale)
    else:
        res = out = torch.empty((rows, c), dtype=out_dtype or torch.float32,
                                device=dev)
    if rows == 0:
        return h, res
    if dev.type == "meta":
        kernel_work(f"ailayernorm_{wrapper.__name__}",
                    io_bytes(x, r, alpha, gamma, beta, h, out, codes, qscale),
                    {"float32": QNORM_OPS_PER_ELEMENT * rows * c}, (rows, c))
        return h, res
    # 4-channel units: C a multiple of 4 and every row or channel array
    # aligned to 4 elements (16 bytes of float32, 8 of bf16, 4 of int8)
    vec = int(c % 4 == 0 and all(
        t.data_ptr() % (4 * t.element_size()) == 0
        for t in (x, r, alpha, gamma, beta, h, out, codes) if t is not None))
    lib = build.load("ailayernorm")
    fn = build.declare(lib, "ailayernorm_static", 10, 8)
    ptrs = [None if t is None else t.data_ptr()
            for t in (x, r, scale, alpha, gamma, beta, h, out, codes, qscale)]
    rc = build.launch(dev, fn, *ptrs, rows, c, int(rms), _ACT_TYPES[x.dtype],
                      _ACT_TYPES[scale.dtype],
                      int(out is not None and out.dtype == torch.bfloat16),
                      int(quant), vec)
    build.check(lib, rc, "ailayernorm_static launch")
    wrapper.launches += 1
    return h, res


def qnorm(x, scale, alpha, gamma, beta=None, *, rms: bool,
          out_dtype=torch.float32) -> torch.Tensor:
    """PTF quantize + integer statistics + affine of each row of ``x``
    (rows, C) float32 or bf16, with the PTF ``scale`` (one element),
    ``alpha`` (C,) int32, ``gamma``/``beta`` (C,) float32 (``beta`` None:
    a zero shift); the output in ``out_dtype``, float32 or bf16."""
    if x.device.type == "cpu":
        return qnorm_plain(x, scale, alpha, gamma, beta, rms=rms,
                           out_dtype=out_dtype)
    return _static_launch(qnorm, x, None, scale, alpha, gamma, beta,
                          rms=rms, out_dtype=out_dtype)[1]


qnorm.launches = 0


def add_norm(x, r, scale, alpha, gamma, beta=None, *, rms: bool,
             out_dtype=torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """``h = x + r`` and the quantize+norm of ``h`` in one pass: x, r
    (rows, C) float32 or bf16 (one dtype) -> (h float32, out in
    ``out_dtype``), both (rows, C); the channel arguments as
    :func:`qnorm`'s."""
    if x.device.type == "cpu":
        return add_norm_plain(x, r, scale, alpha, gamma, beta, rms=rms,
                              out_dtype=out_dtype)
    return _static_launch(add_norm, x, r, scale, alpha, gamma, beta,
                          rms=rms, out_dtype=out_dtype)


add_norm.launches = 0


def add_norm_quant(x, r, scale, alpha, gamma, beta=None, *, rms: bool):
    """:func:`add_norm` with the norm leaving as per-row int8: x, r (rows,
    C) float32 or bf16 -> (h float32, codes int8 (rows, C), scale float32
    (rows, 1))."""
    if x.device.type == "cpu":
        return add_norm_quant_plain(x, r, scale, alpha, gamma, beta, rms=rms)
    h, (codes, qscale) = _static_launch(add_norm_quant, x, r, scale, alpha,
                                        gamma, beta, rms=rms, quant=True)
    return h, codes, qscale


add_norm_quant.launches = 0


def codes_norm(xi, alpha, gamma, beta) -> torch.Tensor:
    """LayerNorm statistics and affine of centred codes ``xi`` (rows, C)
    int32 with per-channel ``alpha`` (C,) int32 -> (rows, C) float32."""
    if xi.device.type == "cpu":
        return codes_norm_plain(xi, alpha, gamma, beta)
    build.refuse_grad("ailayernorm codes_norm", xi, gamma, beta)
    rows, c = xi.shape[0], xi.shape[-1]
    _check_row_args(xi, c, xi=(xi, torch.int32, (rows, c)),
                    **_chan(alpha, gamma, beta, c))
    out = torch.empty((rows, c), dtype=torch.float32, device=xi.device)
    if rows == 0:
        return out
    if xi.device.type == "meta":
        kernel_work("ailayernorm_codes", io_bytes(xi, alpha, gamma, beta, out),
                    {"float32": QNORM_OPS_PER_ELEMENT * rows * c}, (rows, c))
        return out
    lib = build.load("ailayernorm")
    fn = build.declare(lib, "ailayernorm_codes", 5, 2)
    rc = build.launch(xi.device, fn, *(t.data_ptr() for t in
                                       (xi, alpha, gamma, beta, out)),
                      rows, c)
    build.check(lib, rc, "ailayernorm_codes launch")
    codes_norm.launches += 1
    return out


codes_norm.launches = 0


# -- the calibrating norm ------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _fill_eps(dtype: torch.dtype) -> Tuple[float, float]:
    """``calibrate_ptf``'s 1e-8 and 1e-6, as ``full_like`` fills them in
    ``dtype``."""
    return (torch.full((), 1e-8, dtype=dtype).item(),
            torch.full((), 1e-6, dtype=dtype).item())


def calibrated_norm_plain(x, r, gamma, beta, *, rms: bool,
                          out_dtype=torch.float32, quant_out: bool = False):
    """The torch chain the kernel replaces: ``h = x + r`` (``h = x``
    without ``r``) in the activation dtype, ``calibrate_ptf(h)`` over all
    rows, :func:`qnorm_plain` on ``h`` in float32, then the output cast to
    ``out_dtype`` or, with ``quant_out``, ``quantize_act`` of it. Returns
    ``(h, out or (codes, row scale), alpha, scale)``, the scale a (1,)
    float32 tensor. ``gamma``/``beta`` are (C,), or (G, C) with row r of
    ``x`` (flattened to rows of C) taking row r mod G."""
    h = x if r is None else x + r
    params = calibrate_ptf(h, unsigned=not rms)
    out = qnorm_plain(h, params.scale, params.alpha, gamma, beta, rms=rms)
    res = quantize_act(out) if quant_out else out.to(out_dtype)
    return h, res, params.alpha, params.scale.float().reshape(1)


# csrc/ailayernorm.cu's calibrating-norm geometry: threads of a CTA
# (kCalThreads), CTAs of a decode cluster at most (kCalClusterMax), the
# dynamic shared memory a CTA may take (kCalSmemMax: the H100's 227 KB less
# room for the kernel's static shared memory), and the SMs of an H100, the
# grid route's width where no card is asked (the meta device)
CALIB_THREADS = 512
CALIB_CLUSTER_MAX = 16
CALIB_SMEM_MAX = 232448 - 1024
H100_SMS = 132
# the decode route: fewer rows than this, or at most this many elements
CALIB_PREFILL_ROWS = 128
CALIB_DECODE_ELEMENTS = 32768


class CalibPlan(NamedTuple):
    """How ``calib_norm_kernel`` takes a call (:func:`calib_plan`)."""
    route: str      # "cluster" (decode and verify rows) or "grid"
    ctas: int       # CTAs of the launch (a cluster of them, or the grid)
    chunk: int      # rows of a CTA at most (CTA k takes the rows of groups
                    # [k sets / ctas, (k + 1) sets / ctas), sets = rows / G)
    teams: int      # row teams of a CTA (a team of 512 / teams threads)
    keep: int       # rows of a CTA whose h stays in shared memory
    smem: int       # dynamic shared memory of a CTA, bytes
    scratch: int    # float32 elements of device scratch (grid route)


def _r16(n: int) -> int:
    return -(-n // 16) * 16


@functools.lru_cache(maxsize=4096)
def calib_plan(rows: int, c: int, itemsize: int, groups: int = 1,
               sms: int = H100_SMS) -> CalibPlan:
    """The calibrating norm's plan for ``rows`` rows of ``c`` channels of
    ``itemsize`` bytes, the rows a multiple of ``groups`` (the affine's
    rows), from the shape alone. Decode and verify rows (fewer than 128,
    or at most 32,768 elements) take one cluster of up to 16 CTAs, a row
    (or a group of rows) each where there are that few: the code of a
    decode call runs once, so its time is a chain of latencies that more
    CTAs shorten; prefill rows one cooperative launch of up to ``sms``
    CTAs, one an SM (the co-resident limit).
    CTA k takes the consecutive rows of groups [k sets / ctas, (k + 1)
    sets / ctas) (sets = rows / groups, so at most ``chunk`` rows, whole
    groups) and keeps h of as many of them as fit in its shared memory; a
    row
    team is the fewest lanes, a power of two up to a warp, that cover the
    row's 16-byte units, widened while lanes still lack a unit and the
    CTA's rows still take every team at once.
    No bit of a result depends on the plan."""
    if rows < 1 or c < 1 or groups < 1 or rows % groups or sms < 1:
        raise ValueError(f"calib_plan: rows {rows}, C {c}, groups {groups}, "
                         f"sms {sms}")
    sets = rows // groups
    if rows < CALIB_PREFILL_ROWS or rows * c <= CALIB_DECODE_ELEMENTS:
        route = "cluster"
        n = min(CALIB_CLUSTER_MAX, sets)
    else:
        route = "grid"
        n = min(sms, sets)
    chunk = -(-sets // n) * groups
    ctas = n
    units = -(-c * itemsize // 16)
    tt = 1
    while tt < 32 and tt < units:
        tt *= 2
    while (tt < CALIB_THREADS and tt < units
           and CALIB_THREADS // (2 * tt) >= chunk):
        tt *= 2
    fixed = (_r16(4 * c) + _r16(c)
             + (_r16(4 * -(-c // ctas)) if ctas > 1 else 0))
    row_bytes = _r16(c * itemsize)
    keep = max(0, min(chunk, (CALIB_SMEM_MAX - fixed) // row_bytes))
    return CalibPlan(route, ctas, chunk, CALIB_THREADS // tt, keep,
                     fixed + keep * row_bytes,
                     ctas * (c + 1) + c if route == "grid" else 0)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def calibrated_norm_split(x, r, gamma, beta=None, *, rms: bool,
                          amax_reduce, out_dtype=torch.float32,
                          quant_out: bool = False):
    """:func:`calibrated_norm` of ``x`` (..., C), a share of a batch's
    rows, calibrated over the whole batch: ``h = x + r`` and its (C,)
    maxima in torch ops, ``amax_reduce`` (one max all-reduce of C values
    over the data axis) makes them the batch's, ``calibrate_ptf`` derives
    the PTF params from them, and the static-params kernel normalizes the
    rows: :func:`qnorm` (output in ``out_dtype``) or, with ``quant_out``,
    :func:`add_norm_quant` of ``h`` and zero rows (its ``h + 0`` is ``h``
    exactly; the int8 codes and row scale are ``quantize_act`` of the
    norm's float32 output, as the calibrating norm's). On CPU tensors the
    same calls run their plain versions. Every result is bitwise what
    :func:`calibrated_norm_plain` (and so the calibrating kernel) gives
    these rows on the whole batch. ``gamma``/``beta`` (C,) float32
    (``beta`` None for RMS). Returns what :func:`calibrated_norm_plain`
    returns."""
    if gamma.ndim != 1:
        raise ValueError("calibrated_norm_split takes a (C,) affine: no "
                         "model path splits a grouped norm's rows")
    h = x if r is None else x + r
    params = calibrate_ptf(h, unsigned=not rms, amax_reduce=amax_reduce)
    c = x.shape[-1]
    rows = h.reshape(-1, c).contiguous()
    chan = (params.scale, params.alpha, gamma, None if rms else beta)
    if quant_out:
        _, codes, qscale = add_norm_quant(rows, torch.zeros_like(rows),
                                          *chan, rms=rms)
        res = (codes.reshape(x.shape),
               qscale.reshape(x.shape[:-1] + (1,)))
    else:
        res = qnorm(rows, *chan, rms=rms,
                    out_dtype=out_dtype).reshape(x.shape)
    return h, res, params.alpha, params.scale.float().reshape(1)


def calibrated_norm(x, r, gamma, beta=None, *, rms: bool,
                    out_dtype=torch.float32, quant_out: bool = False,
                    with_params: bool = True, amax_reduce=None):
    """The residual add, PTF calibration over all rows and the
    quantize+norm of ``x`` (..., C) float32 or bf16, ``r`` of the same
    shape and type or None, ``gamma``/``beta`` (C,) float32, or (G, C) with
    row r of ``x`` taking row r mod G (``beta`` None for RMS): one launch
    of ``calib_norm_kernel`` on CUDA tensors, which must be contiguous,
    as :func:`calib_plan` lays it out (the grid route's device scratch
    from ``torch.empty``). Returns what
    :func:`calibrated_norm_plain` returns, the output in ``out_dtype``
    (float32 or the activation type);
    ``with_params=False`` leaves out the calibration (None, None) on the
    card, where the model paths need no copy of it. ``amax_reduce``: ``x``
    holds a share of the batch's rows, calibrated over the whole batch
    (:func:`calibrated_norm_split`, on either device)."""
    if amax_reduce is not None:
        return calibrated_norm_split(x, r, gamma, beta, rms=rms,
                                     amax_reduce=amax_reduce,
                                     out_dtype=out_dtype, quant_out=quant_out)
    if x.device.type == "cpu":
        if beta is None:
            beta = torch.zeros_like(gamma)
        return calibrated_norm_plain(x, r, gamma, beta, rms=rms,
                                     out_dtype=out_dtype, quant_out=quant_out)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"no ailayernorm kernel for device {x.device}")
    build.refuse_grad("ailayernorm calibrated_norm", x, r, gamma, beta)
    if x.dtype not in _ACT_TYPES:
        raise TypeError(f"x dtype {x.dtype}: the kernel takes float32 or "
                        "bfloat16")
    if out_dtype not in (torch.float32, x.dtype):
        raise TypeError(f"out_dtype {out_dtype}: float32 or x's {x.dtype}")
    if not rms and beta is None:
        raise ValueError("LayerNorm needs beta")
    c = x.shape[-1]
    rows = x.numel() // c if c else 0
    groups = gamma.shape[0] if gamma.ndim == 2 else 1
    chan = (gamma,) if rms else (gamma, beta)
    if (c > MAX_CHANNELS or not x.is_contiguous() or rows % groups
            or (r is not None and (r.shape != x.shape or r.dtype != x.dtype
                                   or r.device != x.device
                                   or not r.is_contiguous()))
            or any(t.shape != gamma.shape or t.shape[-1:] != (c,)
                   or t.ndim > 2 or t.dtype != torch.float32
                   or t.device != x.device or not t.is_contiguous()
                   for t in chan)):
        raise ValueError(
            f"calibrated_norm takes contiguous x (..., C <= {MAX_CHANNELS}) "
            f"and r alike, gamma/beta (C,) or (G, C) float32 on its device "
            f"(rows a multiple of G); got x "
            f"{tuple(x.shape)} {x.dtype}, r "
            f"{None if r is None else (tuple(r.shape), r.dtype)}, gamma/beta "
            f"{[(tuple(t.shape), t.dtype, str(t.device)) for t in chan]}")
    dev = x.device
    h = x if r is None else torch.empty_like(x)
    alpha = scale = None
    if with_params:
        alpha = torch.empty((c,), dtype=torch.int32, device=dev)
        scale = torch.empty((1,), dtype=torch.float32, device=dev)
    out = codes = qscale = None
    if quant_out:
        codes = torch.empty(x.shape, dtype=torch.int8, device=dev)
        qscale = torch.empty(x.shape[:-1] + (1,), dtype=torch.float32,
                             device=dev)
        res = (codes, qscale)
    else:
        res = out = torch.empty(x.shape, dtype=out_dtype, device=dev)
    if rows == 0:
        return h, res, alpha, scale
    plan = calib_plan(rows, c, x.element_size(), groups,
                      H100_SMS if dev.type == "meta"
                      else _sm_count(dev.index if dev.index is not None
                                     else torch.cuda.current_device()))
    scratch = (torch.empty((plan.scratch,), dtype=torch.float32, device=dev)
               if plan.scratch else None)
    if dev.type == "meta":
        kernel_work("ailayernorm_calib",
                    io_bytes(x, r, gamma, None if rms else beta,
                             None if r is None else h, out, codes, qscale,
                             alpha, scale),
                    {"float32": QNORM_OPS_PER_ELEMENT * rows * c}, (rows, c))
        return h, res, alpha, scale
    n = 16 // x.element_size()
    vec = int(c % n == 0 and all(t.data_ptr() % 16 == 0 for t in
                                 (x, *chan, *(() if r is None else (r, h)))))
    ptrs = [None if t is None else t.data_ptr()
            for t in (x, r, gamma, None if rms else beta,
                      None if r is None else h, out, codes, qscale, alpha,
                      scale, scratch)]
    lib = build.load("ailayernorm")
    fn = build.declare(lib, "ailayernorm_calib", 11, 12, 2)
    eps, eps6 = _fill_eps(x.dtype)
    rc = build.launch(dev, fn, *ptrs, rows, c, groups, int(rms),
                      _ACT_TYPES[x.dtype],
                      int(out_dtype != torch.float32), int(quant_out), vec,
                      int(plan.route == "grid"), plan.ctas, plan.keep,
                      CALIB_THREADS // plan.teams,
                      ctypes.c_float(eps), ctypes.c_float(eps6))
    build.check(lib, rc, "ailayernorm_calib launch")
    calibrated_norm.launches += 1
    return h, res, alpha, scale


calibrated_norm.launches = 0


# -- the exact mode's float norm ----------------------------------------------

def exact_norm_plain(x, gamma, beta=None, *, rms: bool,
                     eps: float) -> torch.Tensor:
    """The exact float32 LayerNorm / RMSNorm in torch ops (the reference
    backend's ``exact_layernorm``/``exact_rmsnorm``): ``mean``, ``square``
    and ``rsqrt`` of each row. On the card torch splits these reductions
    by the number of rows, so a row's bits depend on its batch; the
    kernel does not. ``gamma``/``beta`` (C,), or (G, C) with row r of
    ``x`` (flattened to rows of C) taking row r mod G."""
    shape = x.shape
    x = grouped_rows(x.float(), gamma)
    if rms:
        ms = torch.square(x).mean(-1, keepdim=True)
        return (x * torch.rsqrt(ms + eps) * gamma).reshape(shape)
    mu = x.mean(-1, keepdim=True)
    var = torch.square(x - mu).mean(-1, keepdim=True)
    return ((x - mu) * torch.rsqrt(var + eps) * gamma + beta).reshape(shape)


def _exact_launch(rows, gamma, beta, *, rms: bool, eps: float,
                  written) -> torch.Tensor:
    """One launch of ``exact_norm_kernel`` on rows (R, C): the output
    (R, C) in ``written`` (float32 or bf16)."""
    out = torch.empty(rows.shape, dtype=written, device=rows.device)
    if rows.device.type == "meta":
        kernel_work("ailayernorm_exact", io_bytes(rows, gamma, beta, out),
                    {"float32": EXACT_NORM_OPS_PER_ELEMENT * rows.numel()},
                    rows.shape)
    elif rows.shape[0] and rows.shape[1]:
        lib = build.load("ailayernorm")
        fn = build.declare(lib, "ailayernorm_exact", 4, 6, 1)
        groups = gamma.shape[0] if gamma.ndim == 2 else 1
        rc = build.launch(
            rows.device, fn, rows.data_ptr(), gamma.data_ptr(),
            None if rms else beta.data_ptr(), out.data_ptr(),
            rows.shape[0], rows.shape[1], groups, int(rms),
            _ACT_TYPES[rows.dtype], int(written == torch.bfloat16),
            ctypes.c_float(eps))
        build.check(lib, rc, "ailayernorm_exact launch")
        exact_norm.launches += 1
    return out


# csrc/ailayernorm.cu's exact-norm geometry: channels a thread takes at a
# time (kUnit), units it holds in registers (kExactK), threads of a CTA of
# teams of up to a warp (kExactCta) and of the largest team (kThreads)
EXACT_UNIT = 8
EXACT_UNITS = 4
EXACT_CTA = 128
EXACT_TEAM_MAX = 256
# CTAs the backward aims at, at most: two on each of an H100's 132 SMs. A
# constant, not the card's SM count, so the dgamma/dbeta bits do not depend
# on the card that computes them.
BWD_CTAS = 264


def exact_team(c: int) -> int:
    """Threads of the team that takes a row of ``c`` channels in the exact
    norm's kernels (``exact_team_size``): the fewest, a power of two up to
    256, that leave each thread at most four units of eight channels. Its
    reduction order, and so every row's bits, follow from it."""
    units = -(-c // EXACT_UNIT)
    t = 1
    while t < EXACT_TEAM_MAX and -(-units // t) > EXACT_UNITS:
        t *= 2
    return t


def bwd_plan(rows: int, c: int, groups: int) -> Tuple[int, int]:
    """``(chunk, ctas)`` of the backward kernel, from the shape alone:
    ``chunk`` consecutive rows a CTA, ``rows / BWD_CTAS`` rounded up to a
    whole number of steps, where a step is a row for each of the CTA's
    teams (a multiple of ``groups``, so each team keeps one affine row)
    or, where the team count is not a multiple of ``groups``, ``groups``
    rows. So at most ``BWD_CTAS`` CTAs, and a few rows give each team one
    row. The chunking orders the dgamma/dbeta sums, never a row's dx."""
    t = exact_team(c)
    teams = EXACT_CTA // t if t <= 32 else 1
    step = teams if teams % groups == 0 else groups
    chunk = -(-rows // (BWD_CTAS * step)) * step
    return chunk, -(-rows // chunk)


def exact_norm_backward_plain(x, gamma, beta, dy, *, rms: bool,
                              eps: float):
    """``(dx, dgamma, dbeta)`` by autograd through
    :func:`exact_norm_plain`: dx in x's dtype, dgamma/dbeta float32
    (dbeta None for RMS)."""
    with torch.enable_grad():
        xs = x.detach().requires_grad_(True)
        g = gamma.detach().float().requires_grad_(True)
        b = None if rms else beta.detach().float().requires_grad_(True)
        out = exact_norm_plain(xs, g, b, rms=rms, eps=eps)
        ins = (xs, g) if rms else (xs, g, b)
        grads = torch.autograd.grad(out, ins, dy.float())
    return (grads[0].to(x.dtype), grads[1],
            None if rms else grads[2])


def exact_norm_backward(x, gamma, beta, dy, *, rms: bool, eps: float):
    """The exact norm's gradient: ``(dx (rows, C) in x's dtype, dgamma,
    dbeta)`` (float32, gamma's (C,) or (G, C) shape; dbeta None for RMS)
    from the forward's rows ``x`` (R, C), ``gamma``/``beta`` and ``dy``
    (R, C) float32 or bf16. CUDA tensors: ``exact_norm_bwd_kernel`` then
    ``exact_norm_wgrad_kernel`` (two launches, counted two a call), with
    no atomics, so a call has the same bits on every run and each row's dx
    the same bits whatever the row count; CPU tensors:
    :func:`exact_norm_backward_plain`.
    """
    if x.device.type == "cpu":
        return exact_norm_backward_plain(x, gamma, beta, dy, rms=rms,
                                         eps=eps)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"no ailayernorm kernel for device {x.device}")
    rows, c = x.shape
    groups = gamma.shape[0] if gamma.ndim == 2 else 1
    dy = dy.contiguous()
    if (x.dtype not in _ACT_TYPES or dy.dtype not in _ACT_TYPES
            or dy.shape != x.shape or not x.is_contiguous()
            or gamma.dtype != torch.float32 or not gamma.is_contiguous()
            or (not rms and (beta is None or beta.shape != gamma.shape))
            or rows % groups):
        raise ValueError(
            f"exact_norm_backward takes contiguous x (R, C) and dy alike, "
            f"float32 or bf16, float32 gamma/beta (C,) or (G, C) with R a "
            f"multiple of G; got x {tuple(x.shape)} {x.dtype}, dy "
            f"{tuple(dy.shape)} {dy.dtype}, gamma {tuple(gamma.shape)} "
            f"{gamma.dtype}")
    dev = x.device
    dx = torch.empty_like(x)
    if rows == 0 or c == 0:
        dgamma = torch.zeros(gamma.shape, dtype=torch.float32, device=dev)
        return dx, dgamma, None if rms else torch.zeros_like(dgamma)
    # exact_norm_wgrad_kernel writes every element of dgamma and dbeta
    dgamma = torch.empty(gamma.shape, dtype=torch.float32, device=dev)
    dbeta = None if rms else torch.empty_like(dgamma)
    chunk, ctas = bwd_plan(rows, c, groups)
    parts = ctas * groups * c
    part_g = torch.empty(parts, dtype=torch.float32, device=dev)
    part_b = None if rms else torch.empty_like(part_g)
    if dev.type == "meta":
        kernel_work("ailayernorm_exact_bwd",
                    io_bytes(x, dy, gamma, beta, dx, dgamma, dbeta),
                    {"float32": EXACT_NORM_BWD_OPS_PER_ELEMENT * rows * c},
                    x.shape)
        return dx, dgamma, dbeta
    lib = build.load("ailayernorm")
    fn = build.declare(lib, "ailayernorm_exact_bwd", 8, 7, 1)
    rc = build.launch(
        dev, fn, x.data_ptr(), dy.data_ptr(), gamma.data_ptr(),
        dx.data_ptr(), part_g.data_ptr(),
        None if rms else part_b.data_ptr(), dgamma.data_ptr(),
        None if rms else dbeta.data_ptr(), rows, c, groups, chunk, int(rms),
        _ACT_TYPES[x.dtype], _ACT_TYPES[dy.dtype], ctypes.c_float(eps))
    build.check(lib, rc, "ailayernorm_exact_bwd launch")
    exact_norm_backward.launches += 2    # exact_norm_bwd_kernel + wgrad
    return dx, dgamma, dbeta


exact_norm_backward.launches = 0


class _ExactNorm(torch.autograd.Function):
    """``exact_norm_kernel`` forward, ``exact_norm_backward`` backward."""

    @staticmethod
    def forward(ctx, rows, gamma, beta, rms, eps, written):
        ctx.save_for_backward(rows, gamma, beta)
        ctx.rms, ctx.eps = rms, eps
        return _exact_launch(rows, gamma, beta, rms=rms, eps=eps,
                             written=written)

    @staticmethod
    def backward(ctx, dy):
        rows, gamma, beta = ctx.saved_tensors
        dx, dg, db = exact_norm_backward(rows, gamma, beta, dy, rms=ctx.rms,
                                         eps=ctx.eps)
        need = ctx.needs_input_grad
        return (dx if need[0] else None, dg if need[1] else None,
                db if need[2] else None, None, None, None)


def exact_norm(x, gamma, beta=None, *, rms: bool, eps: float,
               out_dtype=None) -> torch.Tensor:
    """Exact-mode LayerNorm (``beta`` given) or RMSNorm of ``x`` (..., C),
    ``gamma``/``beta`` (C,) or (G, C) (row r takes row r mod G):
    on CUDA tensors one launch of ``exact_norm_kernel`` (a team per row,
    a reduction order fixed by C, so every row has the same bits whatever
    the row count), on CPU tensors :func:`exact_norm_plain`. Float32 out,
    or ``out_dtype`` (float32 or bf16, written by the kernel; another type
    is cast after). Differentiable: where grad mode is on and an input
    requires grad, the launch runs inside a ``torch.autograd.Function``
    whose backward is :func:`exact_norm_backward` (its kernels on the
    card)."""
    if x.device.type == "cpu":
        out = exact_norm_plain(x, gamma, beta, rms=rms, eps=eps)
        return out if out_dtype is None else out.to(out_dtype)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"no ailayernorm kernel for device {x.device}")
    if not rms and beta is None:
        raise ValueError("LayerNorm needs beta")
    c = x.shape[-1]
    (rows,) = _static_rows(x)
    written = _written(out_dtype)
    chan = [gamma.float().contiguous()]
    if not rms:
        chan.append(beta.float().contiguous())
    groups = gamma.shape[0] if gamma.ndim == 2 else 1
    if any(t.shape != gamma.shape or t.shape[-1:] != (c,) or t.ndim > 2
           or t.device != x.device for t in chan) or rows.shape[0] % groups:
        raise ValueError(f"gamma/beta must be ({c},) or (G, {c}) on "
                         f"{x.device} with rows a multiple of G, got "
                         f"{[(tuple(t.shape), str(t.device)) for t in chan]}"
                         f" over {rows.shape[0]} rows")
    beta_t = None if rms else chan[1]
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (rows, *chan)):
        out = _ExactNorm.apply(rows, chan[0], beta_t, rms, eps, written)
    else:
        out = _exact_launch(rows, chan[0], beta_t, rms=rms, eps=eps,
                            written=written)
    return out.reshape(x.shape).to(out_dtype or torch.float32)


exact_norm.launches = 0


# -- entry points in the reference's signatures -------------------------------


def _static_rows(*acts):
    """(rows, C) activations for the static-params kernels: views of
    ``acts`` where they are float32 or bf16 of one dtype (the kernel reads
    them as they are), float32 copies otherwise, made contiguous. On CPU
    tensors the plain versions read them as float32 themselves."""
    c = acts[0].shape[-1]
    rows = [t.reshape(-1, c) for t in acts]
    if rows[0].device.type != "cpu" and (
            rows[0].dtype not in _ACT_TYPES
            or any(t.dtype != rows[0].dtype for t in rows)):
        rows = [t.float() for t in rows]
    return [t.contiguous() for t in rows]


def _written(out_dtype):
    """The output type a static-params kernel writes for ``out_dtype``:
    itself where it is float32 or bf16, else float32, cast after."""
    od = out_dtype or torch.float32
    return od if od in _ACT_TYPES else torch.float32


def _chan_args(params: PTFQuantParams, gamma, beta):
    """The kernels' channel arguments: the PTF scale as it is, alpha,
    gamma and beta (None for a zero shift), with no copy where they
    already have the kernel's types."""
    return (params.scale, params.alpha.to(torch.int32).contiguous(),
            gamma.float().contiguous(),
            None if beta is None else beta.float().contiguous())


def _norm_call(x, params: PTFQuantParams, gamma, beta, rms: bool, out_dtype):
    """Flatten to rows, run :func:`qnorm`, restore the shape."""
    (rows,) = _static_rows(x)
    out = qnorm(rows, *_chan_args(params, gamma, beta), rms=rms,
                out_dtype=_written(out_dtype))
    return out.reshape(x.shape).to(out_dtype or torch.float32)


def _calibrated(x, r, gamma, beta, rms: bool, out_dtype=None,
                quant_out: bool = False, amax_reduce=None):
    """:func:`calibrated_norm` on ``x`` (..., C): ``(h, out)`` or ``(h,
    (codes, scale))`` in ``x``'s shape (``amax_reduce``: its hook)."""
    if not rms and beta is None:
        beta = torch.zeros_like(gamma)
    h, res, _, _ = calibrated_norm(
        x.contiguous(), None if r is None else r.contiguous(),
        gamma.float().contiguous(),
        None if rms else beta.float().contiguous(), rms=rms,
        out_dtype=out_dtype or torch.float32, quant_out=quant_out,
        with_params=False, amax_reduce=amax_reduce)
    return h, res


def ailayernorm(x, gamma, beta, *, params: Optional[PTFQuantParams] = None,
                out_dtype=None, amax_reduce=None) -> torch.Tensor:
    """AILayerNorm (unsigned codes) with the caller's static PTF params,
    or calibrated on the fly over the whole tensor (:func:`calibrated_norm`;
    ``amax_reduce``: over the whole batch ``x`` holds a share of).
    The output is float32 unless ``out_dtype`` names another type (the
    kernels write float32 or bf16; another type is cast after)."""
    if params is None:
        return _calibrated(x, None, gamma, beta, False, out_dtype,
                           amax_reduce=amax_reduce)[1]
    return _norm_call(x, params, gamma, beta, False, out_dtype)


def airmsnorm(x, gamma, *, params: Optional[PTFQuantParams] = None,
              out_dtype=None, amax_reduce=None) -> torch.Tensor:
    """AIRMSNorm (symmetric codes), params as :func:`ailayernorm`."""
    if params is None:
        return _calibrated(x, None, gamma, None, True, out_dtype,
                           amax_reduce=amax_reduce)[1]
    return _norm_call(x, params, gamma, None, True, out_dtype)


def fused_add_norm(x, r, gamma, beta: Optional[torch.Tensor] = None, *,
                   params: Optional[PTFQuantParams] = None,
                   rms: bool = False, out_dtype=None,
                   amax_reduce=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(h, norm(h))`` with ``h = x + r``: the residual carry and the norm
    (float32, or ``out_dtype``). With static ``params`` the add, quantize,
    statistics and affine are one kernel on the rows as they are, and
    ``h`` comes back float32; without them :func:`calibrated_norm` adds
    in the inputs' dtype and calibrates on ``h`` in the same launch
    (``amax_reduce``: over the whole batch ``x`` holds a share of)."""
    if params is None:
        return _calibrated(x, r, gamma, beta, rms, out_dtype,
                           amax_reduce=amax_reduce)
    x2, r2 = _static_rows(x, r)
    h, out = add_norm(x2, r2, *_chan_args(params, gamma,
                                          None if rms else beta),
                      rms=rms, out_dtype=_written(out_dtype))
    return (h.reshape(x.shape),
            out.reshape(x.shape).to(out_dtype or torch.float32))


def fused_add_norm_quant(x, r, gamma, beta: Optional[torch.Tensor] = None, *,
                         params: Optional[PTFQuantParams] = None,
                         rms: bool = False, amax_reduce=None):
    """:func:`fused_add_norm` with the norm leaving as per-row int8:
    ``(h, (codes, scale))``, the scale (..., 1). One kernel either way:
    the static-params one, or :func:`calibrated_norm` with quant-out
    (``amax_reduce``: as :func:`fused_add_norm`'s)."""
    if params is None:
        return _calibrated(x, r, gamma, beta, rms, quant_out=True,
                           amax_reduce=amax_reduce)
    x2, r2 = _static_rows(x, r)
    h, codes, scale = add_norm_quant(
        x2, r2, *_chan_args(params, gamma, None if rms else beta), rms=rms)
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
