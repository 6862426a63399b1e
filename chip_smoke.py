#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU. Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, each fatal on failure (exit code 1, no result line):

1. the card's name and power limit (``nvidia-smi``);
2. build the five CUDA sources from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, started together; eight kernels) and print
   ``-Xptxas -v``;
3. hold each kernel against its plain torch version at the serve paths'
   shapes of qwen2_0_5b: paged prefill (B=1, C=prefill_chunk, causal) and
   decode (B=decode_batch, C=1) over bf16 pools and over int8 pools
   (``quant_pv`` on and off, SOLE and exact), the quantize+norm at those
   rows (C=896, RMS) and at C=2048 (LayerNorm, stablelm's width), and the
   int8 GEMM, bitwise, at every (M, K, N) of the w8a8 path and two ragged
   shapes, and the E2Softmax kernel at the dense-slot path's decode and
   prefill shapes (masked), at two unmasked shapes, with ``int8_scale``
   and with fully masked rows; and the op layer's kernels: the dense
   Flash-E2Softmax at qwen2_0_5b's attention (2048 tokens, causal, in
   four modes), a ragged non-causal case and stablelm_1_6b's MHA, the
   static-PTF fused add+norm and add+norm+quantize-out at qwen2's and
   stablelm's widths, and the LayerNorm of int32 codes;
4. serve greedy requests through ``PagedEngine`` at the full width of
   qwen2_0_5b (24 layers, bf16, SOLE, random weights from a seed), twice:
   first in bf16 (bf16 weights and pages), then at w8a8 with int8 KV
   pages. Every kernel launch counter is set to 0 just before each trace
   and read just after it; check output lengths, finish reasons,
   refcounts and that the path's kernels ran (at w8a8: 169 int8 GEMM
   launches per forward, paged attention over int8 pools); then hold
   smoke-size engines on the card against the same engines on the CPU
   (bf16 exact and SOLE, w8a8 exact with float and int8 pages);
   then the same requests through the dense-slot ``Engine`` (batches of 8,
   384-column caches), in bf16 and at w8a8 with an int8 cache, with the
   launch counts per prefill or decode call checked (24 E2Softmax, 49
   norm, at w8a8 169 GEMM), and the smoke dense engine on the card
   against the CPU (SOLE, and w8a8 exact with an int8 cache); then the
   op layer's path: flash attention, the static-params SOLE norms, their
   residual and quantize-out twins and the codes norm through
   ``repro_torch.ops`` on CUDA tensors, and the port's quickstart
   ``main()``, with the counts read around them (every op-layer kernel,
   E2Softmax and the quantize+norm must launch; the model paths above
   must launch no op-layer kernel);
5. time each kernel and its plain version with CUDA events (L2 flushed
   before every launch), the kernel alone with ``torch.profiler``, beside
   the bound the card's memory rate or peak sets and, for the int8 GEMM,
   ``torch._int_mm`` where it takes the shape, for exact-mode flash
   ``scaled_dot_product_attention`` (yardsticks the port never calls);
6. profile one decode-heavy wave of the paged engine (bf16 and w8a8) and
   of the dense-slot engine (bf16): the device-busy share of the wall time
   and the kernels with the most device time.

Prints the kernel table as one JSON line, the ``nvidia-smi`` line, and
last ``{"ok": true, "device": {...}}``. Exits non-zero without a result
when no CUDA device is available or the port is not beside this file.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
BF16_FLOPS = 989e12                # H100 SXM dense bf16 tensor-core peak
FP32_FLOPS = 67e12                 # H100 SXM float32 outside the tensor cores
INT8_OPS = 1979e12                 # H100 SXM dense int8 tensor-core peak
QNORM_OPS_PER_ELEMENT = 16         # divide, round, clip, square, shifts, sums, affine
E2_OPS_PER_ELEMENT = 16            # max, subtract, snap, multiply, round, clip, 2^-k, sum, scale
DENSE_MAX_LEN = 384                # the dense-slot engine's cache columns
PREFILL_CHUNK = 128
DECODE_BATCH = 8
BLOCK_SIZE = 16
MAX_SEQ_LEN = 512
NEW_TOKENS = 32
# (K, N) of the w8a8 path's GEMMs: wq/wo, wk/wv, gate/up, down, LM head;
# per forward 24 layers x 7 projections + the head.
GEMM_KN = (("wq_wo", 896, 896), ("wk_wv", 896, 128),
           ("gate_up", 896, 4864), ("down", 4864, 896),
           ("head", 896, 151936))
GEMM_PER_FORWARD = 24 * 7 + 1


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


# -- kernel inputs at the path's shapes ---------------------------------------


def paged_case(torch, gen, *, b, c, q_start, kv_lens, h, kvh, d, grid,
               int8=False):
    """Random paged-attention inputs: a pool with shuffled pages, garbage
    in the null page 0, tables covering each sequence's keys. ``grid``
    draws q and k from small integers so every q.k partial sum is exact
    in fp32 and the kernel's codes must equal the plain version's.
    ``int8`` gives int8 code pools (K on the grid, V over the full
    range), as the w8a8 path stores them."""
    dev = "cuda"
    nb = MAX_SEQ_LEN // BLOCK_SIZE
    n = b * nb + 1
    if grid:
        q = torch.randint(-8, 9, (b, h, c, d), generator=gen, device=dev) / 4
        k = torch.randint(-8, 9, (n, BLOCK_SIZE, kvh, d), generator=gen,
                          device=dev).float()
    else:
        q = torch.randn((b, h, c, d), generator=gen, device=dev) * 2
        k = torch.randn((n, BLOCK_SIZE, kvh, d), generator=gen, device=dev)
    v = torch.randn((n, BLOCK_SIZE, kvh, d), generator=gen, device=dev)
    perm = torch.randperm(n - 1, generator=gen, device=dev) + 1
    tables = torch.zeros((b, nb), dtype=torch.int32, device=dev)
    for i, kl in enumerate(kv_lens):
        if kl > 1:                    # kv_len 1: a null lane on page 0
            used = -(-kl // BLOCK_SIZE)
            tables[i, :used] = perm[i * nb:i * nb + used].int()
    meta = torch.tensor([[q_start[i], kv_lens[i]] for i in range(b)],
                        dtype=torch.int32, device=dev)
    bf = torch.bfloat16
    if int8:
        v = torch.randint(-127, 128, v.shape, generator=gen, device=dev)
        k = k if grid else torch.clamp(torch.round(k * 16), -127, 127)
        return (q.to(bf).contiguous(), k.to(torch.int8).contiguous(),
                v.to(torch.int8).contiguous(), tables, meta)
    return (q.to(bf).contiguous(), k.to(bf).contiguous(),
            v.to(bf).contiguous(), tables, meta)


def attention_work(case, causal, h, kvh, d):
    """(bytes, flops) the paged attention must move / do on these inputs:
    q, the live keys' K and V rows and the fp32 output once; 4*d flops
    per unmasked (query, key) pair and head."""
    q, k, _, _, meta = case
    b, _, c, _ = q.shape
    pairs = 0
    keys = 0
    for q_start, kv_len in meta.tolist():
        keys += kv_len
        for r in range(c):
            pairs += min(kv_len, q_start + r + 1) if causal else kv_len
    nbytes = (q.numel() * q.element_size()
              + 2 * keys * kvh * d * k.element_size()
              + b * h * c * d * 4 + meta.numel() * 4)
    return nbytes, 4 * d * pairs * h


def bound_ms(nbytes, flops, flops_rate):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_rate * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def time_ms(torch, fn, flush, reps=30):
    """Mean device time of ``fn`` over ``reps`` calls, each preceded by an
    L2 flush outside its CUDA-event interval. A device-side sleep holds
    the stream while the host enqueues every call, so the intervals hold
    device work only, never the host's launch gaps."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(int((2 * host_s * reps + 2e-3) * 2e9))  # ~2 GHz clock
    for start, end in events:
        flush()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / reps


def profiled_kernel_ms(torch, fn, flush, kernel, reps=20):
    """Mean device time of the kernels whose name holds ``kernel`` per
    call of ``fn`` (L2 flushed before each), from ``torch.profiler``'s
    CUDA activity: the kernel alone, without launch or event overhead.
    None when the profiler records no device time for it."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush()
            fn()
        torch.cuda.synchronize()
    us = sum(_device_us(e) for e in prof.key_averages() if kernel in e.key)
    return us / reps / 1e3 if us > 0 else None


def _device_us(event) -> float:
    for attr in ("device_time_total", "cuda_time_total"):
        if hasattr(event, attr):
            return float(getattr(event, attr))
    return 0.0


# -- phases -------------------------------------------------------------------


def check_kernels(torch, cfg):
    """Phase 3: each kernel against its plain version on the card."""
    from repro_torch.core.sole.quant import calibrate_ptf
    from repro_torch.kernels import ailayernorm as KN
    from repro_torch.kernels import flash_e2softmax as KA
    from repro_torch.models.layers import LOGIT_INT8_SCALE
    gen = torch.Generator(device="cuda").manual_seed(0)
    h, kvh, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kw = dict(sole=True, exp_bits=cfg.exp_bits, int8_scale=LOGIT_INT8_SCALE)
    kvmap = KA.default_kv_head_map(h, kvh, "cuda")
    shapes = {
        "prefill": dict(b=1, c=PREFILL_CHUNK, q_start=[PREFILL_CHUNK],
                        kv_lens=[2 * PREFILL_CHUNK], causal=True),
        "decode": dict(b=DECODE_BATCH, c=1, q_start=[0] * DECODE_BATCH,
                       kv_lens=[49, 300, 117, 1, 256, 83, 160, 1],
                       causal=False),
    }
    results = {}
    for name, sh in shapes.items():
        causal = sh.pop("causal")
        res = {}
        for grid in (True, False):
            case = paged_case(torch, gen, h=h, kvh=kvh, d=d, grid=grid, **sh)
            out = KA.flash_e2softmax_paged(*case, causal=causal, **kw)
            ref = KA.flash_e2softmax_paged_plain(*case, kvmap, causal=causal,
                                                 **kw)
            torch.cuda.synchronize()
            err = (out - ref).abs()
            if not torch.isfinite(out).all():
                raise AssertionError(f"paged_e2softmax {name}: non-finite")
            row_err = err.amax(-1).flatten()
            if grid:
                # exact logits -> identical codes; only the P.V sum order
                # (fp32) differs: relative 1e-5 of the output scale.
                tol = 1e-5 * max(ref.abs().max().item(), 1.0)
                if err.max().item() > tol:
                    raise AssertionError(
                        f"paged_e2softmax {name}: max |err| "
                        f"{err.max().item()} > {tol} on exact-logit inputs")
                res["max_abs_err"] = err.max().item()
            else:
                # real-valued logits: the dot order may move a logit across
                # an int8-snap rounding boundary and flip one 4-bit code;
                # at most 1% of rows may differ by more than 1e-3.
                frac = (row_err > 1e-3).float().mean().item()
                if frac > 0.01:
                    raise AssertionError(
                        f"paged_e2softmax {name}: {frac:.4f} of rows off "
                        "by > 1e-3 on random inputs")
                res["max_abs_err_random"] = err.max().item()
                res["rows_off_random"] = frac
                res["case"] = case
                res["causal"] = causal
        results[name] = res
        log(f"paged_e2softmax {name}: max|err| exact-logit "
            f"{res['max_abs_err']:.3e}, random {res['max_abs_err_random']:.3e}"
            f" ({res['rows_off_random']:.4f} of rows > 1e-3)")

    norm = {}
    for name, rows, c, rms in (("prefill", PREFILL_CHUNK, cfg.d_model, True),
                               ("decode", DECODE_BATCH, cfg.d_model, True),
                               ("layernorm_2048", PREFILL_CHUNK, 2048, False)):
        x = torch.randn((rows, c), generator=gen, device="cuda") * 3
        x[:, :: 7] *= 8                        # outlier channels, alpha > 0
        x = x.to(torch.bfloat16)
        gamma = 1 + 0.1 * torch.randn((c,), generator=gen, device="cuda")
        beta = 0.1 * torch.randn((c,), generator=gen, device="cuda")
        p = calibrate_ptf(x, unsigned=not rms)
        args = (x.float().contiguous(), p.denom().contiguous(),
                p.alpha.contiguous(), gamma,
                torch.zeros_like(beta) if rms else beta)
        out = KN.qnorm(*args, rms=rms)
        ref = KN.qnorm_plain(*args, rms=rms)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        # integer codes and sums are exact and the epilogue rounds like
        # the plain ops, so the two agree to fp32 rounding (1e-6 rel.).
        tol = 1e-6 * max(ref.abs().max().item(), 1.0)
        if not torch.isfinite(out).all() or err > tol:
            raise AssertionError(f"ailayernorm {name}: max |err| {err} > {tol}")
        norm[name] = dict(max_abs_err=err, args=args, rms=rms)
        log(f"ailayernorm_qnorm {name} rows={rows} C={c} "
            f"{'rms' if rms else 'ln'}: max|err| {err:.3e}")
    return results, norm


def check_int8_paged(torch, cfg):
    """Phase 3, int8 pools: the paged kernel against its plain version at
    the decode and prefill-chunk shapes, ``quant_pv`` on and off, SOLE
    (int8-snapped logits) and exact, on exact-logit inputs: identical
    codes, only the P.V sum order differs (1e-5 of the output scale)."""
    from repro_torch.kernels import flash_e2softmax as KA
    from repro_torch.models.layers import KV_INT8_SCALE, LOGIT_INT8_SCALE
    gen = torch.Generator(device="cuda").manual_seed(1)
    h, kvh, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kvmap = KA.default_kv_head_map(h, kvh, "cuda")
    shapes = {
        "prefill": dict(b=1, c=PREFILL_CHUNK, q_start=[PREFILL_CHUNK],
                        kv_lens=[2 * PREFILL_CHUNK]),
        "decode": dict(b=DECODE_BATCH, c=1, q_start=[0] * DECODE_BATCH,
                       kv_lens=[49, 300, 117, 1, 256, 83, 160, 1]),
    }
    results = {}
    for name, sh in shapes.items():
        causal = name == "prefill"
        case = paged_case(torch, gen, h=h, kvh=kvh, d=d, grid=True,
                          int8=True, **sh)
        errs = {}
        for mode in ("sole", "exact"):
            for quant_pv in (True, False):
                kw = dict(sole=mode == "sole", exp_bits=cfg.exp_bits,
                          int8_scale=LOGIT_INT8_SCALE if mode == "sole"
                          else None, kv_scale=KV_INT8_SCALE, quant_pv=quant_pv)
                out = KA.flash_e2softmax_paged(*case, causal=causal, **kw)
                ref = KA.flash_e2softmax_paged_plain(*case, kvmap,
                                                     causal=causal, **kw)
                torch.cuda.synchronize()
                err = (out - ref).abs().max().item()
                tol = 1e-5 * max(ref.abs().max().item(), 1.0)
                if not torch.isfinite(out).all() or err > tol:
                    raise AssertionError(
                        f"paged_e2softmax int8 {name} {mode} quant_pv="
                        f"{quant_pv}: max |err| {err} > {tol}")
                errs[f"{mode}{'_pv' if quant_pv else ''}"] = err
        results[name] = dict(case=case, causal=causal, errs=errs,
                             max_abs_err=max(errs.values()))
        log(f"paged_e2softmax int8 pools {name}: max|err| " + ", ".join(
            f"{k} {v:.3e}" for k, v in errs.items()))
    return results


def check_int8_gemm(torch):
    """Phase 3, int8 GEMM: bitwise equal to its plain version (float64,
    exact) at every path shape (M = decode_batch or prefill_chunk) and
    two ragged ones, on random codes with one all-127 row and column
    (the largest sums)."""
    from repro_torch.kernels import int8_matmul as KM
    gen = torch.Generator(device="cuda").manual_seed(2)
    shapes = [(f"{nm}_m{m}", m, k, n) for m in (DECODE_BATCH, PREFILL_CHUNK)
              for nm, k, n in GEMM_KN]
    shapes += [("ragged_7x130x33", 7, 130, 33),
               ("ragged_64x256x128", 64, 256, 128)]
    results = {}
    for name, m, k, n in shapes:
        x = torch.randint(-127, 128, (m, k), generator=gen, device="cuda",
                          dtype=torch.int8)
        w = torch.randint(-127, 128, (k, n), generator=gen, device="cuda",
                          dtype=torch.int8)
        x[0] = 127
        w[:, 0] = 127
        out = KM.int8_matmul(x, w)
        ref = KM.int8_matmul_plain(x, w)
        torch.cuda.synchronize()
        if out.dtype != torch.int32 or not torch.equal(out, ref):
            bad = (out != ref).sum().item()
            raise AssertionError(f"int8_matmul {name} ({m}x{k}x{n}): "
                                 f"{bad} of {out.numel()} outputs differ")
        results[name] = dict(x=x, w=w, max_abs_err=0.0)
    log(f"int8_matmul: bitwise equal to the plain version at {len(shapes)}"
        " shapes: " + ", ".join(f"{nm} {m}x{k}x{n}"
                               for nm, m, k, n in shapes))
    return results


def e2_match(torch, out, ref, c, exp_bits=4):
    """Kernel against plain E2Softmax: equal bit for bit while every
    partial sum is exact (exp_bits 4, C <= 512); above that the two sum
    in other orders and a row whose S rounds differently can only move
    its ALDivision bucket, so each row must equal the plain row or differ
    from it by one constant ratio, and at most 0.1% of rows may differ.
    Returns (max |err|, share of rows that differ)."""
    err = (out - ref).abs().max().item() if out.numel() else 0.0
    if not torch.isfinite(out).all():
        raise AssertionError("e2softmax: non-finite output")
    same = (out == ref).all(-1)
    off = 1.0 - same.float().mean().item()
    if c <= 512 and exp_bits == 4:
        if off:
            raise AssertionError(f"e2softmax C={c}: {off:.4f} of rows differ"
                                 f" (max |err| {err}) where sums are exact")
        return err, off
    if off > 1e-3:
        raise AssertionError(f"e2softmax C={c}: {off:.4f} of rows differ")
    for i in torch.nonzero(~same).flatten().tolist():
        nz = ref[i] != 0
        ratio = out[i][nz] / ref[i][nz]
        if not torch.equal(ratio, ratio[:1].expand_as(ratio)):
            raise AssertionError(f"e2softmax C={c}: row {i} differs in codes")
    return err, off


def check_e2softmax(torch, cfg):
    """Phase 3, E2Softmax: the kernel against its plain version at the
    dense-slot path's shapes of qwen2_0_5b (decode: 8 lanes x 14 heads
    rows of T+1 = 385 columns; prefill: 8 x 14 x 300 rows of 300
    columns; both masked, logits snapped as the path snaps them), at the
    JAX kernel benchmark's unmasked (8, 785) and (2, 8192), once with the
    kernel's own ``int8_scale`` and once with fully masked rows."""
    from repro_torch import ops
    from repro_torch.kernels import e2softmax as KE
    from repro_torch.models.layers import LOGIT_INT8_SCALE
    gen = torch.Generator(device="cuda").manual_seed(3)
    h, t = cfg.n_heads, DENSE_MAX_LEN
    dev = "cuda"

    def path_logits(rows, c, mask):
        raw = torch.randn((rows, c), generator=gen, device=dev) * 4
        m = torch.where(mask, raw, -torch.inf).amax(-1, keepdim=True)
        return ops.snap_logits(raw - torch.clamp_min(m, -1e30),
                               LOGIT_INT8_SCALE)

    # decode: lane b sees its cache columns up to a per-lane length, never
    # the write slot, plus the current token (column T)
    lens = torch.tensor([49, 300, 117, 1, 256, 83, 160, 1], device=dev)
    cols = torch.arange(t + 1, device=dev)
    dmask = (cols[None] < lens[:, None]) | (cols[None] == t)
    dmask = dmask[:, None].expand(8, h, t + 1).reshape(8 * h, t + 1)
    # prefill: causal over 300 columns with per-lane left padding
    s = 300
    n_pad = torch.tensor([252, 0, 180, 100, 196, 136, 220, 50], device=dev)
    pos = torch.arange(s, device=dev)
    local = pos[None] - n_pad[:, None]
    kpos = torch.where(local < 0, 2 ** 30, local)
    qpos = torch.clamp_min(local, 0)
    pmask = (kpos[:, None, :] < 2 ** 29) & (qpos[:, :, None] >= kpos[:, None])
    pmask = pmask[:, None].expand(8, h, s, s).reshape(8 * h * s, s)
    full = dmask.clone()
    full[:5] = False
    cases = {
        "decode": (path_logits(8 * h, t + 1, dmask), dmask, None),
        "prefill": (path_logits(8 * h * s, s, pmask), pmask.contiguous(),
                    None),
        "bench_785": (torch.randn((8, 785), generator=gen, device=dev) * 4,
                      None, None),
        "bench_8192": (torch.randn((2, 8192), generator=gen, device=dev) * 4,
                       None, None),
        "int8_scale": (torch.randn((8 * h, t + 1), generator=gen,
                                   device=dev) * 4, dmask, LOGIT_INT8_SCALE),
        "fully_masked_rows": (path_logits(8 * h, t + 1, full), full, None),
    }
    results = {}
    for name, (x, mask, snap) in cases.items():
        kw = dict(exp_bits=cfg.exp_bits, int8_scale=snap, mask=mask)
        out = KE.e2softmax(x, **kw)
        ref = KE.e2softmax_plain(x, **kw)
        torch.cuda.synchronize()
        c = x.shape[-1]
        err, off = e2_match(torch, out, ref, c)
        if mask is not None and (out[~mask] != 0).any():
            raise AssertionError(f"e2softmax {name}: a masked entry is not 0")
        if name == "fully_masked_rows" and (out[:5] != 0).any():
            raise AssertionError("e2softmax: a fully masked row is not 0")
        results[name] = dict(x=x, mask=mask, kw=kw, max_abs_err=err,
                             rows_off=off)
        log(f"e2softmax {name} rows={x.shape[0]} C={c} "
            f"{'masked' if mask is not None else 'unmasked'}"
            f"{' int8_scale' if snap else ''}: max|err| {err:.3e}, "
            f"rows that differ {off:.5f}")
    return results


OPS_KERNELS = ("flash_e2softmax", "ailayernorm_add_norm",
               "ailayernorm_add_norm_quant", "ailayernorm_codes")


def kernel_wrappers():
    """Each kernel's launch-counting wrapper, by kernel name."""
    from repro_torch.kernels import ailayernorm as KN
    from repro_torch.kernels import e2softmax as KE
    from repro_torch.kernels import flash_e2softmax as KA
    from repro_torch.kernels import int8_matmul as KM
    return {"paged_e2softmax": KA.flash_e2softmax_paged,
            "ailayernorm_qnorm": KN.qnorm, "int8_matmul": KM.int8_matmul,
            "e2softmax": KE.e2softmax, "flash_e2softmax": KA.flash_e2softmax,
            "ailayernorm_add_norm": KN.add_norm,
            "ailayernorm_add_norm_quant": KN.add_norm_quant,
            "ailayernorm_codes": KN.codes_norm}


def reset_launches() -> None:
    for fn in kernel_wrappers().values():
        fn.launches = 0


def read_launches():
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


def trace_prompts(cfg):
    """The trace's prompts: eight for wave 1 (48-300 tokens, two on a
    shared 64-token system prompt) and wave 2's new prompt on the system
    prompt, from seed 0."""
    import numpy as np
    rng = np.random.default_rng(0)
    system = rng.integers(0, cfg.vocab_size, 64)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (48, 300, 120, 200)]
    prompts += [np.concatenate([system, rng.integers(0, cfg.vocab_size, n)])
                for n in (40, 100)]
    prompts += [rng.integers(0, cfg.vocab_size, n) for n in (80, 250)]
    tail = np.concatenate([system, rng.integers(0, cfg.vocab_size, 30)])
    return ([p.astype(np.int32) for p in prompts], tail.astype(np.int32))


def eos_outcome(o, eos):
    """1 if a request whose eos ids are ``eos`` was cut right after its
    first eos token, 0 if it never sampled one and got its full budget;
    raises otherwise."""
    if o and o[-1] in eos and not any(t in eos for t in o[:-1]):
        return 1
    if len(o) == NEW_TOKENS and not any(t in eos for t in o):
        return 0
    raise AssertionError(f"eos request broke the finish contract: {o}")


def serve_full_width(torch, cfg, label):
    """Phase 4: one main path at full width, counts from this run only.
    At w8a8 also checks 169 int8 GEMM launches per forward (24 paged
    attention launches mark one forward) and int8 page pools, and reports
    the peak device memory of the trace."""
    from repro_torch.models import api
    from repro_torch.serve.engine import PagedEngine, Request

    t0 = time.time()
    params = api.init_params(0, cfg, "cuda")
    torch.cuda.synchronize()
    log(f"[{label}] init_params: {time.time() - t0:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    eng = PagedEngine(cfg, params, num_blocks=8 * MAX_SEQ_LEN // BLOCK_SIZE + 1,
                      block_size=BLOCK_SIZE, max_seq_len=MAX_SEQ_LEN,
                      max_running=8, decode_batch=DECODE_BATCH,
                      prefill_chunk=PREFILL_CHUNK, decode_horizon=8,
                      device="cuda")
    prompts, tail = trace_prompts(cfg)
    wave1 = [Request(prompt=p, max_new_tokens=NEW_TOKENS) for p in prompts]

    reset_launches()
    torch.cuda.synchronize()
    t0 = time.time()
    out1 = eng.generate(wave1)
    torch.cuda.synchronize()
    t1 = time.time() - t0
    # wave 2: a repeat of request 0 whose eos ids are every token wave 1
    # produced (a prefix hit that should finish by eos), and a second
    # request on the shared system prompt (a prefix hit on its pages).
    eos = sorted({t for o in out1 for t in o})
    wave2 = [Request(prompt=prompts[0], max_new_tokens=NEW_TOKENS,
                     eos_ids=tuple(eos)),
             Request(prompt=tail, max_new_tokens=NEW_TOKENS)]
    t0 = time.time()
    out2 = eng.generate(wave2)
    torch.cuda.synchronize()
    t2 = time.time() - t0
    launches = read_launches()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    stats = eng.stats()
    eng.cache.check_refcounts()

    for i, o in enumerate(out1):
        if len(o) != NEW_TOKENS:
            raise AssertionError(f"wave 1 request {i}: {len(o)} tokens")
    if not all(0 <= t < cfg.vocab_size for o in out1 + out2 for t in o):
        raise AssertionError("token id out of range")
    o = out2[0]
    eos_fired = eos_outcome(o, set(eos))
    if len(out2[1]) != NEW_TOKENS:
        raise AssertionError(f"wave 2 request 1: {len(out2[1])} tokens")
    want = {"length": 10 - eos_fired, "eos": eos_fired}
    if stats["finish_reasons"] != {k: v for k, v in want.items() if v}:
        raise AssertionError(f"finish reasons {stats['finish_reasons']}")
    if stats["prefix_hit_tokens"] < 64 + len(prompts[0]) - 1:
        raise AssertionError(f"prefix hits {stats['prefix_hit_tokens']}")
    w8a8 = cfg.quant.acts
    path_kernels = (("paged_e2softmax", "ailayernorm_qnorm", "int8_matmul")
                    if w8a8 else ("paged_e2softmax", "ailayernorm_qnorm"))
    for name in path_kernels:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the path")
    forwards, rest = divmod(launches["paged_e2softmax"], cfg.n_layers)
    if rest:
        raise AssertionError(f"{launches['paged_e2softmax']} attention "
                             f"launches are not whole forwards")
    if w8a8:
        if launches["int8_matmul"] != GEMM_PER_FORWARD * forwards:
            raise AssertionError(
                f"{launches['int8_matmul']} int8 GEMM launches over "
                f"{forwards} forwards, not {GEMM_PER_FORWARD} each")
        dtypes = {str(p.dtype) for p in eng.cache.pools.values()}
        if dtypes != {"torch.int8"}:
            raise AssertionError(f"w8a8 trace pools are {dtypes}, not int8")
    elif launches["int8_matmul"]:
        raise AssertionError("the bf16 path launched the int8 GEMM")
    if launches["e2softmax"]:
        raise AssertionError("the paged path launched the E2Softmax kernel")
    if any(launches[k] for k in OPS_KERNELS):
        raise AssertionError("the paged path launched an op-layer kernel")
    n_tok = sum(len(o) for o in out1 + out2)
    log(f"[{label}] served {len(out1) + len(out2)} requests, {n_tok} new "
        f"tokens: wave 1 {t1:.3f} s, wave 2 {t2:.3f} s "
        f"({n_tok / (t1 + t2):.1f} tok/s); eos request: {len(o)} tokens, "
        f"eos fired: {eos_fired}; {forwards} forwards; peak device memory "
        f"{peak_gib:.3f} GiB")
    log(f"[{label}] engine stats: " + json.dumps(stats, sort_keys=True))
    log(f"[{label}] launches on the path: " + json.dumps(launches))
    return launches, {"wave1_s": t1, "wave2_s": t2, "new_tokens": n_tok,
                      "eos_fired": eos_fired, "forwards": forwards,
                      "max_memory_allocated_gib": peak_gib}, params


def serve_dense_full_width(torch, cfg, params, label):
    """Phase 4, the dense-slot path: the trace's requests through
    ``Engine`` (batches of 8 lanes, 384-column caches) at full width, the
    counts set to 0 just before and read just after. Each prefill or
    decode call must launch the E2Softmax kernel once per layer (24), the
    norm kernel 49 times and, at w8a8, the int8 GEMM 169 times, and never
    the paged kernel."""
    from repro_torch.models import layers as L
    from repro_torch.serve.engine import Engine, Request
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident_gib = torch.cuda.memory_allocated() / 2 ** 30
    eng = Engine(cfg, params, batch_size=DECODE_BATCH, max_len=DENSE_MAX_LEN,
                 device="cuda")
    prompts, tail = trace_prompts(cfg)
    wave1 = [Request(prompt=p, max_new_tokens=NEW_TOKENS) for p in prompts]
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.time()
    out1 = eng.generate(wave1)
    torch.cuda.synchronize()
    t1 = time.time() - t0
    reasons = list(eng.finish_reasons)
    eos = sorted({t for o in out1 for t in o})
    wave2 = [Request(prompt=prompts[0], max_new_tokens=NEW_TOKENS,
                     eos_ids=tuple(eos)),
             Request(prompt=tail, max_new_tokens=NEW_TOKENS)]
    t0 = time.time()
    out2 = eng.generate(wave2)
    torch.cuda.synchronize()
    t2 = time.time() - t0
    launches = read_launches()
    reasons += eng.finish_reasons
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    outs = out1 + out2
    for i, o in enumerate(outs):
        log(f"[{label}] request {i}: {o}")
    if any(len(o) != NEW_TOKENS for o in out1 + out2[1:]):
        raise AssertionError(f"token counts {[len(o) for o in outs]}")
    if not all(0 <= t < cfg.vocab_size for o in outs for t in o):
        raise AssertionError("token id out of range")
    eos_fired = eos_outcome(out2[0], set(eos))
    want = ["length"] * 8 + ["eos" if eos_fired else "length", "length"]
    if reasons != want:
        raise AssertionError(f"finish reasons {reasons}")
    calls = eng.prefill_calls + eng.decode_calls
    want_launches = {"e2softmax": cfg.n_layers * calls,
                     "ailayernorm_qnorm": (2 * cfg.n_layers + 1) * calls,
                     "int8_matmul": (GEMM_PER_FORWARD * calls
                                     if cfg.quant.acts else 0),
                     "paged_e2softmax": 0, **{k: 0 for k in OPS_KERNELS}}
    if launches != want_launches:
        raise AssertionError(f"launches {launches} over {calls} calls, "
                             f"expected {want_launches}")
    if cfg.quant.acts and L.kv_store_dtype(cfg) != torch.int8:
        raise AssertionError("the w8a8 dense trace does not cache int8")
    n_tok = sum(len(o) for o in outs)
    log(f"[{label}] served {len(outs)} requests, {n_tok} new tokens: wave 1 "
        f"{t1:.3f} s, wave 2 {t2:.3f} s ({n_tok / (t1 + t2):.1f} tok/s); "
        f"eos request: {len(out2[0])} tokens, eos fired: {eos_fired}; "
        f"{eng.prefill_calls} prefill + {eng.decode_calls} decode calls; "
        f"peak device memory {peak_gib:.3f} GiB ({resident_gib:.3f} GiB "
        "resident before the engine was built)")
    log(f"[{label}] launches on the path: " + json.dumps(launches))
    return launches, {"wave1_s": t1, "wave2_s": t2, "new_tokens": n_tok,
                      "eos_fired": eos_fired, "prefill_calls":
                      eng.prefill_calls, "decode_calls": eng.decode_calls,
                      "max_memory_allocated_gib": peak_gib,
                      "resident_before_gib": resident_gib}


def small_engine_parity(torch):
    """The same smoke-size trace through the kernels (cuda) and the plain
    versions (cpu): in bf16, >= 95% of greedy tokens equal in exact and
    SOLE mode (cuBLAS and the CPU sum in other orders; in SOLE mode a
    logit that moves across a rounding boundary flips a code); at w8a8 in
    exact mode, with float and with int8 pages, tokens equal (every
    projection is an exact int32 sum). The dense-slot engine likewise in
    SOLE mode and at w8a8 exact with an int8 cache."""
    import numpy as np
    from repro_torch.configs.base import QuantConfig, get_config
    from repro_torch.models import api
    from repro_torch.serve.engine import Engine, PagedEngine, Request
    exact = dict(softmax_mode="exact", norm_mode="exact", logit_int8=False)
    w8a8 = dict(exact, quant=QuantConfig("w8a8"))
    for mode, change, bar in (
            ("exact", exact, 0.95), ("sole", {}, 0.95),
            ("w8a8 exact", w8a8, 1.0),
            ("w8a8 exact int8 kv", dict(w8a8, kv_cache_dtype="int8"), 1.0)):
        cfg = dataclasses.replace(get_config("qwen2_0_5b").smoke(), **change)
        params = api.init_params(0, cfg, "cpu")
        rng = np.random.default_rng(1)
        reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, n)
                        .astype(np.int32), max_new_tokens=8)
                for n in (5, 20, 12, 30, 9)]
        outs = []
        for dev in ("cpu", "cuda"):
            eng = PagedEngine(cfg, params, num_blocks=32, block_size=8,
                              max_seq_len=64, decode_batch=4,
                              prefill_chunk=8, device=dev)
            outs.append(eng.generate(reqs))
            eng.cache.check_refcounts()
        check_agreement(outs, f"paged {mode}", bar)
    for mode, change, bar in (
            ("sole", {}, 0.95),
            ("w8a8 exact int8 kv", dict(w8a8, kv_cache_dtype="int8"), 1.0)):
        cfg = dataclasses.replace(get_config("qwen2_0_5b").smoke(), **change)
        params = api.init_params(0, cfg, "cpu")
        rng = np.random.default_rng(1)
        reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, n)
                        .astype(np.int32), max_new_tokens=8)
                for n in (5, 20, 12, 30, 9)]
        outs = [Engine(cfg, params, batch_size=4, max_len=64,
                       device=dev).generate(reqs) for dev in ("cpu", "cuda")]
        check_agreement(outs, f"dense {mode}", bar)


def check_agreement(outs, label, bar):
    """Share of equal greedy tokens between the CPU and card outputs."""
    if any(len(o) != 8 for o in outs[1]):
        raise AssertionError(f"smoke {label}: token counts")
    pairs = [(a, b) for x, y in zip(*outs) for a, b in zip(x, y)]
    agree = sum(a == b for a, b in pairs) / len(pairs)
    log(f"smoke engine cuda vs cpu, {label}: token agreement {agree:.3f}")
    if agree < bar:
        raise AssertionError(f"smoke parity {label}: {agree} < {bar}")


def time_kernels(torch, attn, norm, launches, cfg):
    """Phase 5: CUDA-event times of each kernel and its plain version,
    and the kernel's own device time from ``torch.profiler``."""
    from repro_torch.kernels import ailayernorm as KN
    from repro_torch.kernels import flash_e2softmax as KA
    from repro_torch.models.layers import LOGIT_INT8_SCALE
    flush_buf = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    flush = flush_buf.zero_
    h, kvh, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kvmap = KA.default_kv_head_map(h, kvh, "cuda")
    kw = dict(sole=True, exp_bits=cfg.exp_bits, int8_scale=LOGIT_INT8_SCALE)
    table = []
    entry = {"paged_e2softmax": dict(
        name="paged_e2softmax", route="cuda",
        source="src/repro_torch/kernels/csrc/paged_e2softmax.cu",
        replaces="src/repro/kernels/flash_e2softmax.py:186", shapes={}),
        "ailayernorm_qnorm": dict(
        name="ailayernorm_qnorm", route="cuda",
        source="src/repro_torch/kernels/csrc/ailayernorm.cu",
        replaces="src/repro/kernels/ailayernorm.py:133", shapes={})}
    for name, res in attn.items():
        case, causal = res["case"], res["causal"]

        def run():
            return KA.flash_e2softmax_paged(*case, causal=causal, **kw)
        ms = time_ms(torch, run, flush)
        kernel_ms = profiled_kernel_ms(torch, run, flush,
                                       "paged_e2softmax_kernel")
        plain = time_ms(torch, lambda: KA.flash_e2softmax_paged_plain(
            *case, kvmap, causal=causal, **kw), flush, reps=5)
        nbytes, flops = attention_work(case, causal, h, kvh, d)
        bms, by = bound_ms(nbytes, flops, BF16_FLOPS)
        entry["paged_e2softmax"]["shapes"][name] = dict(
            shape=f"q {tuple(case[0].shape)} kv_len {case[4][:, 1].tolist()}",
            ms=ms, kernel_ms=kernel_ms, plain_ms=plain, bound_ms=bms,
            bound_by=by,
            max_abs_err=res["max_abs_err"],
            max_abs_err_random=res["max_abs_err_random"],
            bytes=nbytes, flops=flops)
    for name, res in norm.items():
        args, rms = res["args"], res["rms"]

        def run():
            return KN.qnorm(*args, rms=rms)
        ms = time_ms(torch, run, flush)
        kernel_ms = profiled_kernel_ms(torch, run, flush, "qnorm_kernel")
        plain = time_ms(torch, lambda: KN.qnorm_plain(*args, rms=rms), flush)
        rows, c = args[0].shape
        nbytes = 2 * rows * c * 4 + 4 * c * 4
        bms, by = bound_ms(nbytes, QNORM_OPS_PER_ELEMENT * rows * c,
                           FP32_FLOPS)
        entry["ailayernorm_qnorm"]["shapes"][name] = dict(
            shape=f"rows {rows} C {c} {'rms' if rms else 'ln'}", ms=ms,
            kernel_ms=kernel_ms, plain_ms=plain, bound_ms=bms, bound_by=by,
            max_abs_err=res["max_abs_err"], bytes=nbytes)
    for key, e in entry.items():
        main = e["shapes"]["decode"]            # the most-launched shape
        e.update(launches=launches[key], max_abs_err=max(
            s["max_abs_err"] for s in e["shapes"].values()),
            ms=main["ms"], plain_ms=main["plain_ms"],
            bound_ms=main["bound_ms"], bound_by=main["bound_by"],
            library_ms=None)
        table.append(e)
    for e in table:
        for s, v in e["shapes"].items():
            k = v["kernel_ms"]
            log(f"{e['name']} {s} [{v['shape']}]: {v['ms'] * 1e3:.1f} us "
                f"(profiler: kernel "
                f"{'not measured' if k is None else f'{k * 1e3:.1f} us'}; "
                f"plain {v['plain_ms'] * 1e3:.1f} us, bound "
                f"{v['bound_ms'] * 1e3:.2f} us by {v['bound_by']})")
    return table


def time_e2softmax(torch, e2, launches, launches8):
    """Phase 5 for the E2Softmax kernel: CUDA-event and profiler times at
    the path's decode and prefill shapes and the two benchmark shapes,
    the plain version's time, and the bound: the logits and mask read
    once and the float32 output written once at the card's memory rate
    (the ~16 operations per element are far below its peak)."""
    from repro_torch.kernels import e2softmax as KE
    flush_buf = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    flush = flush_buf.zero_
    entry = dict(name="e2softmax", route="cuda",
                 source="src/repro_torch/kernels/csrc/e2softmax.cu",
                 replaces="src/repro/kernels/e2softmax.py:48", shapes={})
    for name in ("decode", "prefill", "bench_785", "bench_8192"):
        res = e2[name]
        x, kw = res["x"], res["kw"]
        mask = kw["mask"]

        def run():
            return KE.e2softmax(x, **kw)
        nbytes = (x.numel() * x.element_size() + x.numel() * 4
                  + (0 if mask is None else mask.numel()))
        bms, by = bound_ms(nbytes, E2_OPS_PER_ELEMENT * x.numel(), FP32_FLOPS)
        entry["shapes"][name] = dict(
            shape=f"rows {x.shape[0]} C {x.shape[1]} "
                  f"{'masked' if mask is not None else 'unmasked'}",
            ms=time_ms(torch, run, flush),
            kernel_ms=profiled_kernel_ms(torch, run, flush,
                                         "e2softmax_kernel"),
            plain_ms=time_ms(torch, lambda: KE.e2softmax_plain(x, **kw),
                             flush, reps=10),
            bound_ms=bms, bound_by=by, max_abs_err=res["max_abs_err"],
            rows_off=res["rows_off"], bytes=nbytes)
    top = entry["shapes"]["decode"]            # the most-launched shape
    entry.update(launches=launches["e2softmax"],
                 launches_w8a8=launches8["e2softmax"],
                 max_abs_err=max(v["max_abs_err"] for v in e2.values()),
                 ms=top["ms"], plain_ms=top["plain_ms"],
                 bound_ms=top["bound_ms"], bound_by=top["bound_by"],
                 library_ms=None, main_shape="decode")
    for sname, v in entry["shapes"].items():
        k = v["kernel_ms"]
        log(f"e2softmax {sname} [{v['shape']}]: {v['ms'] * 1e3:.1f} us "
            f"(profiler: kernel "
            f"{'not measured' if k is None else f'{k * 1e3:.1f} us'}; "
            f"plain {v['plain_ms'] * 1e3:.1f} us, bound "
            f"{v['bound_ms'] * 1e3:.2f} us by {v['bound_by']})")
    return [entry]


def _int_mm_ms(torch, x, w, flush):
    """``torch._int_mm`` (cuBLAS) on the same inputs, the yardstick:
    (ms, note), or (None, why it refused). The port never calls it."""
    from repro_torch.kernels.int8_matmul import int8_matmul_plain
    try:
        exact = torch.equal(torch._int_mm(x, w), int8_matmul_plain(x, w))
    except RuntimeError as e:
        return None, "torch._int_mm refuses: " + str(e).strip()[:120]
    ms = time_ms(torch, lambda: torch._int_mm(x, w), flush)
    return ms, "torch._int_mm" + ("" if exact else
                                  ", NOT equal to the exact product")


def time_w8a8_kernels(torch, attn8, gemm, launches, cfg):
    """Phase 5 for the w8a8 path: the paged kernel over int8 pools (SOLE,
    ``quant_pv``, as the path runs it) and the int8 GEMM at every path
    shape, timed like the bf16 kernels; launches from the w8a8 trace."""
    from repro_torch.kernels import flash_e2softmax as KA
    from repro_torch.kernels import int8_matmul as KM
    from repro_torch.models.layers import KV_INT8_SCALE, LOGIT_INT8_SCALE
    flush_buf = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    flush = flush_buf.zero_
    h, kvh, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kvmap = KA.default_kv_head_map(h, kvh, "cuda")
    kw = dict(sole=True, exp_bits=cfg.exp_bits, int8_scale=LOGIT_INT8_SCALE,
              kv_scale=KV_INT8_SCALE, quant_pv=True)
    paged = dict(name="paged_e2softmax_int8kv", route="cuda",
                 source="src/repro_torch/kernels/csrc/paged_e2softmax.cu",
                 replaces="src/repro/kernels/flash_e2softmax.py:186",
                 shapes={})
    for name, res in attn8.items():
        case, causal = res["case"], res["causal"]

        def run():
            return KA.flash_e2softmax_paged(*case, causal=causal, **kw)
        nbytes, flops = attention_work(case, causal, h, kvh, d)
        bms, by = bound_ms(nbytes, flops, BF16_FLOPS)
        paged["shapes"][name] = dict(
            shape=f"q {tuple(case[0].shape)} int8 pools kv_len "
                  f"{case[4][:, 1].tolist()}",
            ms=time_ms(torch, run, flush),
            kernel_ms=profiled_kernel_ms(torch, run, flush,
                                         "paged_e2softmax_kernel"),
            plain_ms=time_ms(torch, lambda: KA.flash_e2softmax_paged_plain(
                *case, kvmap, causal=causal, **kw), flush, reps=5),
            bound_ms=bms, bound_by=by, max_abs_err=res["max_abs_err"],
            bytes=nbytes, flops=flops)
    mm = dict(name="int8_matmul", route="cuda",
              source="src/repro_torch/kernels/csrc/int8_matmul.cu",
              replaces="src/repro/kernels/int8_matmul.py:29", shapes={})
    for name, res in gemm.items():
        if name.startswith("ragged"):
            continue
        x, w = res["x"], res["w"]
        (m, k), n = x.shape, w.shape[1]
        nbytes = m * k + k * n + 4 * m * n
        bms, by = bound_ms(nbytes, 2 * m * k * n, INT8_OPS)
        lib_ms, lib_note = _int_mm_ms(torch, x, w, flush)
        mm["shapes"][name] = dict(
            shape=f"M {m} K {k} N {n}",
            ms=time_ms(torch, lambda: KM.int8_matmul(x, w), flush),
            kernel_ms=profiled_kernel_ms(torch, lambda: KM.int8_matmul(x, w),
                                         flush, "int8_matmul_kernel"),
            plain_ms=time_ms(torch, lambda: KM.int8_matmul_plain(x, w),
                             flush, reps=5),
            library_ms=lib_ms, library=lib_note, bound_ms=bms, bound_by=by,
            max_abs_err=0.0, bytes=nbytes, ops=2 * m * k * n)
    # the most-launched shapes: a decode step; for the GEMM its largest,
    # the LM head
    for e, key, main in ((paged, "paged_e2softmax", "decode"),
                         (mm, "int8_matmul", f"head_m{DECODE_BATCH}")):
        top = e["shapes"][main]
        e.update(launches=launches[key], max_abs_err=max(
            v["max_abs_err"] for v in e["shapes"].values()),
            ms=top["ms"], plain_ms=top["plain_ms"], bound_ms=top["bound_ms"],
            bound_by=top["bound_by"], library_ms=top.get("library_ms"),
            main_shape=main)
    for e in (paged, mm):
        for sname, v in e["shapes"].items():
            k = v["kernel_ms"]
            lib = v.get("library")
            log(f"{e['name']} {sname} [{v['shape']}]: {v['ms'] * 1e3:.1f} us "
                f"(profiler: kernel "
                f"{'not measured' if k is None else f'{k * 1e3:.1f} us'}; "
                f"plain {v['plain_ms'] * 1e3:.1f} us, bound "
                f"{v['bound_ms'] * 1e3:.2f} us by {v['bound_by']}"
                + ("" if lib is None else
                   f"; {lib}: " + ("-" if v["library_ms"] is None
                                   else f"{v['library_ms'] * 1e3:.1f} us"))
                + ")")
    return [paged, mm]


# -- the op layer: dense flash, static-PTF fused norms, the codes norm --------

# (B, S, T, H, KV, hd, causal) of the dense flash cases: qwen2_0_5b's
# attention at 2048 tokens, a ragged non-causal case, stablelm_1_6b's MHA
FLASH_CASES = {"qwen2_causal": (1, 2048, 2048, 14, 2, 64, True),
               "ragged_noncausal": (2, 300, 1000, 14, 2, 64, False),
               "stablelm_mha": (1, 2048, 2048, 32, 32, 64, True)}
# (case, mode) of each flash check: "sole_int8" snaps the logits to the
# path's int8 grid, "sole_exact_corr" rescales by the float32 correction
FLASH_MODES = (("qwen2_causal", "sole"), ("qwen2_causal", "sole_int8"),
               ("qwen2_causal", "sole_exact_corr"), ("qwen2_causal", "exact"),
               ("ragged_noncausal", "sole"), ("stablelm_mha", "sole"))
FLASH_BLOCK = 128
# (rows, C, rms) of the static-PTF norms: qwen2_0_5b's RMS width at decode,
# prefill-chunk and 2048-token rows; stablelm_1_6b's LayerNorm width
NORM_CASES = ((8, 896, True), (128, 896, True), (2048, 896, True),
              (128, 2048, False), (2048, 2048, False))
CODES_SHAPE = (2048, 2048)


def ops_inputs(torch):
    """The op layer's inputs, from seeds: flash q/k/v in bf16 on exact-
    logit grids (q in quarters, k integers, head dim 64 so d^-1/2 = 1/8:
    every q.k partial sum is exact), plus one real-valued qwen2 case;
    norm activations with outlier channels (every PTF alpha) and static
    params calibrated once on a held-out batch of the same shape; int32
    codes in [-128, 127] with alpha in 0..3."""
    from repro_torch.core.sole.quant import calibrate_ptf
    gen = torch.Generator(device="cuda").manual_seed(14)
    dev, bf = "cuda", torch.bfloat16

    def randint(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=dev)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    flash = {}
    for name, (b, s, t, h, kvh, hd, causal) in FLASH_CASES.items():
        flash[name] = dict(q=(randint(-8, 9, (b, s, h, hd)) / 4).to(bf),
                           k=randint(-8, 9, (b, t, kvh, hd)).to(bf),
                           v=randn(b, t, kvh, hd).to(bf), causal=causal)
    b, s, t, h, kvh, hd, _ = FLASH_CASES["qwen2_causal"]
    flash["qwen2_random"] = dict(q=(randn(b, s, h, hd) * 2).to(bf),
                                 k=randn(b, t, kvh, hd).to(bf),
                                 v=randn(b, t, kvh, hd).to(bf), causal=True)

    def acts(rows, c):
        x = randn(rows, c) * 2
        x[:, ::7] *= 8
        return x

    norms = {}
    for rows, c, rms in NORM_CASES:
        held_out = acts(rows, c)
        norms[f"{'rms' if rms else 'ln'}_{rows}x{c}"] = dict(
            x=acts(rows, c), r=randn(rows, c), rms=rms,
            params=calibrate_ptf(held_out, unsigned=not rms),
            gamma=1 + 0.1 * randn(c), beta=0.1 * randn(c))
    c = CODES_SHAPE[1]
    codes = dict(xi=randint(-128, 128, CODES_SHAPE).int(),
                 alpha=randint(0, 4, (c,)).int(), gamma=1 + 0.1 * randn(c),
                 beta=0.1 * randn(c))
    return dict(flash=flash, norms=norms, codes=codes)


def _fold(torch, case):
    """The flash op's kernel inputs: K/V repeated to every query head,
    all three folded to (B * H, ., hd)."""
    from repro_torch.ops.reference import fold_heads, repeat_kv
    h = case["q"].shape[2]
    return [fold_heads(x).contiguous() for x in
            (case["q"], repeat_kv(case["k"], h), repeat_kv(case["v"], h))]


def _flash_kw(mode, causal):
    """The kernel's keyword arguments for one ``FLASH_MODES`` mode."""
    from repro_torch.models.layers import LOGIT_INT8_SCALE
    return dict(causal=causal, sole=mode != "exact", exp_bits=4,
                int8_scale=LOGIT_INT8_SCALE if mode == "sole_int8" else None,
                exact_corr=mode == "sole_exact_corr", block_q=FLASH_BLOCK,
                block_k=FLASH_BLOCK)


def norm_args(case):
    p = case["params"]
    beta = case["beta"] * 0 if case["rms"] else case["beta"]
    return (case["x"], case["r"], p.denom().contiguous(), p.alpha,
            case["gamma"], beta)


def check_ops_kernels(torch, inp):
    """Phase 3, the op layer's kernels against their plain versions at full
    width: the dense Flash-E2Softmax (exact-logit inputs: 1e-5 of the
    output scale, only the w.v order differs; real-valued logits: at most
    1% of rows off by more than 1e-3), the fused add+norm (``h`` bitwise,
    the norm to 1e-6) and add+norm+quantize-out (``h`` bitwise; codes and
    scale bitwise equal to ``quantize_act`` of the add+norm kernel's
    output), and the codes norm (1e-6)."""
    from repro_torch.core.sole.quant import quantize_act
    from repro_torch.kernels import ailayernorm as KN
    from repro_torch.kernels import flash_e2softmax as KA
    res = {"flash": {}, "norms": {}}
    for name, mode in FLASH_MODES + (("qwen2_random", "sole_int8"),):
        case = inp["flash"][name]
        args = _fold(torch, case)
        kkw = _flash_kw(mode, case["causal"])
        out = KA.flash_e2softmax(*args, **kkw)
        ref = KA.flash_e2softmax_plain(*args, **kkw)
        torch.cuda.synchronize()
        if not torch.isfinite(out).all():
            raise AssertionError(f"flash_e2softmax {name} {mode}: non-finite")
        err = (out - ref).abs()
        scale = max(ref.abs().max().item(), 1.0)
        if name == "qwen2_random":
            off = (err.amax(-1) > 1e-3 * scale).float().mean().item()
            if off > 0.01:
                raise AssertionError(f"flash_e2softmax random logits: {off}"
                                     " of rows off by > 1e-3")
            log(f"flash_e2softmax {name} {mode}: max|err| "
                f"{err.max().item():.3e}, rows off {off:.5f}")
            res["flash_random"] = dict(max_abs_err=err.max().item(),
                                       rows_off=off)
            continue
        if err.max().item() > 1e-5 * scale:
            raise AssertionError(f"flash_e2softmax {name} {mode}: max |err| "
                                 f"{err.max().item()} > {1e-5 * scale}")
        res["flash"][f"{name}_{mode}"] = dict(
            name=name, mode=mode, max_abs_err=err.max().item(), args=args,
            kkw=kkw, out=out)
        log(f"flash_e2softmax {name} {mode} q {tuple(case['q'].shape)} "
            f"kv {tuple(case['k'].shape)}: max|err| {err.max().item():.3e}")
    for name, case in inp["norms"].items():
        args, rms = norm_args(case), case["rms"]
        h, out = KN.add_norm(*args, rms=rms)
        h8, codes, scale = KN.add_norm_quant(*args, rms=rms)
        h_ref, out_ref = KN.add_norm_plain(*args, rms=rms)
        _, codes_ref, scale_ref = KN.add_norm_quant_plain(*args, rms=rms)
        torch.cuda.synchronize()
        err = (out - out_ref).abs().max().item()
        tol = 1e-6 * max(out_ref.abs().max().item(), 1.0)
        want_codes, want_scale = quantize_act(out)
        if not (torch.equal(h, h_ref) and torch.equal(h8, h_ref)):
            raise AssertionError(f"fused norm {name}: h is not bitwise x + r")
        if not torch.isfinite(out).all() or err > tol:
            raise AssertionError(f"add_norm {name}: max |err| {err} > {tol}")
        if not (torch.equal(codes, want_codes)
                and torch.equal(scale, want_scale)):
            raise AssertionError(f"add_norm_quant {name}: codes or scale "
                                 "differ from quantize_act of add_norm")
        agree = (codes == codes_ref).float().mean().item()
        res["norms"][name] = dict(max_abs_err=err, codes_vs_plain=agree,
                                  args=args, rms=rms, h=h, out=out,
                                  codes=codes, scale=scale)
        log(f"ailayernorm fused {name}: h bitwise, norm max|err| {err:.3e}, "
            f"quant-out codes/scale bitwise = quantize_act(add_norm), codes "
            f"equal to the plain version's: {agree:.6f}")
    cd = inp["codes"]
    cargs = (cd["xi"], cd["alpha"], cd["gamma"], cd["beta"])
    out = KN.codes_norm(*cargs)
    ref = KN.codes_norm_plain(*cargs)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    tol = 1e-6 * max(ref.abs().max().item(), 1.0)
    if not torch.isfinite(out).all() or err > tol:
        raise AssertionError(f"codes_norm: max |err| {err} > {tol}")
    res["codes"] = dict(max_abs_err=err, args=cargs, out=out)
    log(f"ailayernorm codes {tuple(cd['xi'].shape)}: max|err| {err:.3e}")
    return res


def serve_ops_path(torch, inp, res):
    """Phase 4, the op layer's path: every op call through the public
    ``repro_torch.ops`` entry points on CUDA tensors (flash attention in
    each mode and case, the static-params SOLE norms and their residual
    and quantize-out twins, the codes norm), then the port's quickstart
    ``main()``, with the counts set to 0 just before and read just after.
    The registry must route each to the cuda backend, each output must
    equal the kernel's checked in phase 3, and kernels A-D, E2Softmax
    and the quantize+norm must have launched."""
    from repro_torch import ops
    from repro_torch.kernels import ailayernorm as KN
    from repro_torch.launch import quickstart
    dev = torch.device("cuda")
    for op, mode in (("flash_attention", "sole"), ("flash_attention", "exact"),
                     ("layernorm", "sole"), ("rmsnorm", "sole"),
                     ("residual_layernorm", "sole"),
                     ("residual_rmsnorm_q", "sole")):
        if ops.backend_for(op, mode, dev) != "cuda":
            raise AssertionError(f"{op} {mode} does not resolve to cuda")
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.time()
    outs = {}
    for name, mode in FLASH_MODES:
        case = inp["flash"][name]
        kkw = _flash_kw(mode, case["causal"])
        outs[f"{name}_{mode}"] = ops.flash_attention_fn(
            "exact" if mode == "exact" else "sole", dev)(
            case["q"], case["k"], case["v"], causal=case["causal"],
            block=FLASH_BLOCK, int8_scale=kkw["int8_scale"],
            exact_corr=kkw["exact_corr"])
    for name, case in inp["norms"].items():
        kind = "rmsnorm" if case["rms"] else "layernorm"
        extra = () if case["rms"] else (case["beta"],)
        p = case["params"]
        outs[f"norm_{name}"] = getattr(ops, f"{kind}_fn")("sole", dev)(
            case["x"], case["gamma"], *extra, params=p)
        outs[f"res_{name}"] = ops.residual_norm_fn(kind, "sole", dev)(
            case["x"], case["r"], case["gamma"], *extra, params=p)
        outs[f"resq_{name}"] = ops.residual_norm_q_fn(kind, "sole", dev)(
            case["x"], case["r"], case["gamma"], *extra, params=p)
    cd = inp["codes"]
    outs["codes"] = KN.ailayernorm_codes(cd["xi"], cd["alpha"], cd["gamma"],
                                         cd["beta"])
    if quickstart.main([]) != 0:
        raise AssertionError("quickstart failed")
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = read_launches()
    want_zero = ("paged_e2softmax", "int8_matmul")
    for k in OPS_KERNELS + ("e2softmax", "ailayernorm_qnorm"):
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} never launched on the op path")
    if any(launches[k] for k in want_zero):
        raise AssertionError(f"op path launched {want_zero}: {launches}")
    if launches["flash_e2softmax"] != len(FLASH_MODES) + 1:
        raise AssertionError(f"{launches['flash_e2softmax']} flash launches")
    for key, r in res["flash"].items():
        b, s, _, h, _, hd, _ = FLASH_CASES[r["name"]]
        want = r["out"].reshape(b, h, s, hd).transpose(1, 2).to(torch.bfloat16)
        if not torch.equal(outs[key], want):
            raise AssertionError(f"flash op {key}: output differs from the "
                                 "kernel's")
    for name, r in res["norms"].items():
        h, out = outs[f"res_{name}"]
        hq, (codes, scale) = outs[f"resq_{name}"]
        if not (torch.equal(h, r["h"]) and torch.equal(out, r["out"])
                and torch.equal(hq, r["h"]) and torch.equal(codes, r["codes"])
                and torch.equal(scale, r["scale"])
                and torch.isfinite(outs[f"norm_{name}"]).all()):
            raise AssertionError(f"static-params norm ops {name} differ from "
                                 "the kernels'")
    if not torch.equal(outs["codes"], res["codes"]["out"]):
        raise AssertionError("codes norm op differs from the kernel's")
    log(f"op path: {len(outs)} op calls and the quickstart in {wall:.2f} s; "
        "launches: " + json.dumps(launches))
    return launches


def _causal_pairs(s, t, causal):
    """(query, key) pairs a row-by-row attention computes: causal row r
    sees min(r + 1, t) keys."""
    if not causal:
        return s * t
    n = min(s, t)
    return n * (n + 1) // 2 + (s - n) * t


def time_ops_kernels(torch, res, launches):
    """Phase 5 for the op layer's kernels: CUDA-event times (L2 flushed)
    and profiler times at every checked shape, the plain versions' times,
    the bound (flash: q, k, v read once in bf16 and the float32 output
    written once, against 4 d flops per computed (query, key) pair at the
    bf16 peak; norms: the rows read and written once at the memory rate)
    and, for exact-mode flash, ``scaled_dot_product_attention`` on the
    same expanded bf16 q/k/v (a yardstick the port never calls)."""
    import torch.nn.functional as F
    from repro_torch.kernels import ailayernorm as KN
    from repro_torch.kernels import flash_e2softmax as KA
    flush_buf = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    flush = flush_buf.zero_
    flash = dict(name="flash_e2softmax", route="cuda",
                 source="src/repro_torch/kernels/csrc/flash_e2softmax.cu",
                 replaces="src/repro/kernels/flash_e2softmax.py:82",
                 shapes={})
    for key, r in res["flash"].items():
        args, kkw = r["args"], r["kkw"]
        b, s, t, h, _, hd, causal = FLASH_CASES[r["name"]]
        nbytes = sum(x.numel() * x.element_size() for x in args) \
            + b * h * s * hd * 4
        flops = 4 * hd * b * h * _causal_pairs(s, t, causal)
        bms, by = bound_ms(nbytes, flops, BF16_FLOPS)
        lib = None
        if r["mode"] == "exact":
            q4, k4, v4 = (x.reshape(b, h, -1, hd) for x in args)
            lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
                q4, k4, v4, is_causal=causal), flush)

        def run():
            return KA.flash_e2softmax(*args, **kkw)
        flash["shapes"][key] = dict(
            shape=f"BH {b * h} S {s} T {t} d {hd} "
                  f"{'causal' if causal else 'non-causal'} {r['mode']}",
            ms=time_ms(torch, run, flush),
            kernel_ms=profiled_kernel_ms(torch, run, flush,
                                         "flash_e2softmax_dense_kernel"),
            plain_ms=time_ms(torch, lambda: KA.flash_e2softmax_plain(
                *args, **kkw), flush, reps=3),
            bound_ms=bms, bound_by=by, library_ms=lib,
            library="torch.nn.functional.scaled_dot_product_attention"
            if lib is not None else None,
            max_abs_err=r["max_abs_err"], bytes=nbytes, flops=flops)
    add = dict(name="ailayernorm_add_norm", route="cuda",
               source="src/repro_torch/kernels/csrc/ailayernorm.cu",
               replaces="src/repro/kernels/ailayernorm.py:205", shapes={})
    addq = dict(name="ailayernorm_add_norm_quant", route="cuda",
                source="src/repro_torch/kernels/csrc/ailayernorm.cu",
                replaces="src/repro/kernels/ailayernorm.py:257", shapes={})
    for name, r in res["norms"].items():
        args, rms = r["args"], r["rms"]
        rows, c = args[0].shape
        for e, fn, plain, out_bytes, kname in (
                (add, KN.add_norm, KN.add_norm_plain, 8, "add_norm_kernel"),
                (addq, KN.add_norm_quant, KN.add_norm_quant_plain, 5,
                 "add_norm_quant_kernel")):
            nbytes = rows * c * (8 + out_bytes) + 16 * c \
                + (4 * rows if e is addq else 0)
            bms, by = bound_ms(nbytes, (QNORM_OPS_PER_ELEMENT + 4) * rows * c,
                               FP32_FLOPS)

            def run(fn=fn):
                return fn(*args, rms=rms)
            e["shapes"][name] = dict(
                shape=f"rows {rows} C {c} {'rms' if rms else 'ln'}",
                ms=time_ms(torch, run, flush),
                kernel_ms=profiled_kernel_ms(torch, run, flush, kname),
                plain_ms=time_ms(torch, lambda plain=plain: plain(
                    *args, rms=rms), flush, reps=10),
                bound_ms=bms, bound_by=by, library_ms=None,
                max_abs_err=r["max_abs_err"], bytes=nbytes)
    codes = dict(name="ailayernorm_codes", route="cuda",
                 source="src/repro_torch/kernels/csrc/ailayernorm.cu",
                 replaces="src/repro/kernels/ailayernorm.py:53", shapes={})
    cargs = res["codes"]["args"]
    rows, c = cargs[0].shape
    nbytes = rows * c * 8 + 12 * c
    bms, by = bound_ms(nbytes, QNORM_OPS_PER_ELEMENT * rows * c, FP32_FLOPS)
    codes["shapes"]["codes"] = dict(
        shape=f"rows {rows} C {c} int32 codes",
        ms=time_ms(torch, lambda: KN.codes_norm(*cargs), flush),
        kernel_ms=profiled_kernel_ms(torch, lambda: KN.codes_norm(*cargs),
                                     flush, "codes_norm_kernel"),
        plain_ms=time_ms(torch, lambda: KN.codes_norm_plain(*cargs), flush,
                         reps=10),
        bound_ms=bms, bound_by=by, library_ms=None,
        max_abs_err=res["codes"]["max_abs_err"], bytes=nbytes)
    table = []
    for e, main in ((flash, "qwen2_causal_sole"), (add, "rms_2048x896"),
                    (addq, "rms_2048x896"), (codes, "codes")):
        top = e["shapes"][main]
        e.update(launches=launches[e["name"]], max_abs_err=max(
            v["max_abs_err"] for v in e["shapes"].values()),
            ms=top["ms"], plain_ms=top["plain_ms"], bound_ms=top["bound_ms"],
            bound_by=top["bound_by"], library_ms=top["library_ms"],
            main_shape=main)
        table.append(e)
        for sname, v in e["shapes"].items():
            k, lib = v["kernel_ms"], v["library_ms"]
            log(f"{e['name']} {sname} [{v['shape']}]: {v['ms'] * 1e3:.1f} us "
                f"(profiler: kernel "
                f"{'not measured' if k is None else f'{k * 1e3:.1f} us'}; "
                f"plain {v['plain_ms'] * 1e3:.1f} us, bound "
                f"{v['bound_ms'] * 1e3:.2f} us by {v['bound_by']}"
                + ("" if lib is None else f"; SDPA {lib * 1e3:.1f} us") + ")")
    return table


def profile_engine(torch, cfg, params, label, dense=False):
    """Where the time goes on a main path: one decode-heavy wave
    (8 requests, 128-token prompts, 32 new tokens) through the paged
    engine, or the dense-slot one, under torch.profiler. Prints the
    device-busy share of the wall time and the kernels with the most
    device time; returns the summary."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve.engine import Engine, PagedEngine, Request
    if dense:
        eng = Engine(cfg, params, batch_size=DECODE_BATCH,
                     max_len=DENSE_MAX_LEN, device="cuda")
    else:
        eng = PagedEngine(
            cfg, params, num_blocks=8 * MAX_SEQ_LEN // BLOCK_SIZE + 1,
            block_size=BLOCK_SIZE, max_seq_len=MAX_SEQ_LEN, max_running=8,
            decode_batch=DECODE_BATCH, prefill_chunk=PREFILL_CHUNK,
            decode_horizon=8, device="cuda")
    rng = np.random.default_rng(2)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, 128)
                    .astype(np.int32), max_new_tokens=NEW_TOKENS)
            for _ in range(DECODE_BATCH)]
    eng.generate(reqs[:1])                      # warm the allocator
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        eng.generate(reqs)
        torch.cuda.synchronize()
        wall = time.time() - t0
    rows = sorted(((_device_us(e), e.count, e.key)
                   for e in prof.key_averages() if _device_us(e) > 0),
                  reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    log(f"[{label}] profiled wave: wall {wall:.3f} s, device busy "
        f"{busy:.3f} s ({busy / wall:.3f} of wall), "
        f"{len(reqs) * NEW_TOKENS} new tokens")
    for us, n, key in rows[:12]:
        log(f"  {us / 1e3:9.2f} ms {n:7d} x  {key[:100]}")
    return {"wall_s": wall, "device_busy_s": busy,
            "top": [{"ms": us / 1e3, "count": n, "kernel": key[:100]}
                    for us, n, key in rows[:12]]}


def main() -> int:
    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    try:
        from repro_torch.configs.base import QuantConfig, get_config
        from repro_torch.kernels import build
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.time()
    try:
        smi = nvidia_smi_line()
        log(f"card: {smi}")
        log(f"torch {torch.__version__} cuda {torch.version.cuda}, "
            f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
        t0 = time.time()
        logs = build.build_all()
        log(f"kernel build: {time.time() - t0:.1f} s")
        for name, text in logs.items():
            for line in text.splitlines():
                if "ptxas" in line or "bytes" in line:
                    log(f"[{name}] {line.strip()}")
        cfg = get_config("qwen2_0_5b")
        cfg8 = dataclasses.replace(cfg, quant=QuantConfig("w8a8"),
                                   kv_cache_dtype="int8")
        attn, norm = check_kernels(torch, cfg)
        attn8 = check_int8_paged(torch, cfg)
        gemm = check_int8_gemm(torch)
        e2 = check_e2softmax(torch, cfg)
        ops_inp = ops_inputs(torch)
        ops_res = check_ops_kernels(torch, ops_inp)
        launches, trace, params = serve_full_width(torch, cfg, "bf16")
        launches8, trace8, params8 = serve_full_width(torch, cfg8, "w8a8")
        dlaunches, dtrace = serve_dense_full_width(torch, cfg, params,
                                                   "dense bf16")
        dlaunches8, dtrace8 = serve_dense_full_width(torch, cfg8, params8,
                                                     "dense w8a8")
        olaunches = serve_ops_path(torch, ops_inp, ops_res)
        small_engine_parity(torch)
        table = time_kernels(torch, attn, norm, launches, cfg)
        table += time_w8a8_kernels(torch, attn8, gemm, launches8, cfg)
        table += time_e2softmax(torch, e2, dlaunches, dlaunches8)
        table += time_ops_kernels(torch, ops_res, olaunches)
        for e in table:
            if e["name"] == "ailayernorm_qnorm":
                e["launches_w8a8"] = launches8["ailayernorm_qnorm"]
                e["launches_dense"] = dlaunches["ailayernorm_qnorm"]
                e["launches_ops"] = olaunches["ailayernorm_qnorm"]
            if e["name"] == "e2softmax":
                e["launches_ops"] = olaunches["e2softmax"]
            if e["name"] == "int8_matmul":
                e["launches_dense_w8a8"] = dlaunches8["int8_matmul"]
        trace["profile"] = profile_engine(torch, cfg, params, "bf16")
        dtrace["profile"] = profile_engine(torch, cfg, params, "dense bf16",
                                           dense=True)
        del params
        trace8["profile"] = profile_engine(torch, cfg8, params8, "w8a8")
        log(json.dumps({"trace": trace, "trace_w8a8": trace8,
                        "trace_dense": dtrace, "trace_dense_w8a8": dtrace8}))
        log(f"chip_smoke: every phase passed in {time.time() - t_start:.1f} s")
    except Exception:
        traceback.print_exc()
        return 1
    print(json.dumps({"kernels": table}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
