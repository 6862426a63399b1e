#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU. Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, each fatal on failure (exit code 1, no result line):

1. the card's name and power limit (``nvidia-smi``);
2. build the five CUDA sources from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, started together; nine kernels), print
   ``-Xptxas -v`` and count the tensor-core instructions in the dense
   flash and int8 GEMM kernels' SASS (``cuobjdump -sass``; the bf16 flash
   kernel must issue bf16 ``HMMA``);
3. hold each kernel against its plain torch version at the serve paths'
   shapes of qwen2_0_5b: paged prefill (B=1, C=prefill_chunk, causal) and
   decode (B=decode_batch, C=1) over bf16 pools and over int8 pools
   (``quant_pv`` on and off, SOLE and exact; bf16 q runs the tensor-core
   kernel, one CTA per sequence and KV head), the static-params
   quantize+norm at those rows (C=896, RMS) and at C=2048 (LayerNorm,
   stablelm's width) bitwise on bf16 rows and their float32 view, the
   calibrating norm (residual add, calibration over all rows and norm in
   one cluster launch) bitwise against the torch chain it replaces at the
   decode, prefill and dense-prefill (2400) rows and at C=2048, and the
   int8 GEMM, bitwise, at every (M, K, N) of the w8a8 path, two ragged
   shapes and four whose K splits are uneven, each on two calls in a row
   (the split's tickets reset themselves), with at least 132 CTAs at
   every path shape, and the E2Softmax kernel at the dense-slot path's decode and
   prefill shapes (masked), at two unmasked shapes, with ``int8_scale``
   and with fully masked rows, and the path's whole ``_sole_probs`` stage
   (one ``softmax`` op call on raw logits with the path's broadcast or
   concatenated mask, the int8 snap in the kernel, bf16 out) bitwise
   equal to the chain it replaced, with one launch and exactly one
   device kernel per call under ``torch.profiler``; and the op layer's kernels: the dense
   Flash-E2Softmax in four modes at qwen2_0_5b's attention (2048 tokens,
   causal), a ragged non-causal case, stablelm_1_6b's MHA, a causal case
   whose last k-block is not a multiple of 16, one shorter than 16 rows,
   one at head dim 128 (held to a share of rows) and qwen2's case in
   float32 (the CUDA-core instantiation; bf16 runs on the tensor cores),
   the static-PTF quantize+norm, fused add+norm and add+norm+quantize-out
   at qwen2's and stablelm's widths, each bitwise equal to its plain
   version on float32 rows and on bf16 rows (bf16 out), and the LayerNorm
   of int32 codes;
4. serve greedy requests through ``PagedEngine`` at the full width of
   qwen2_0_5b (24 layers, bf16, SOLE, random weights from a seed), twice:
   first in bf16 (bf16 weights and pages), then at w8a8 with int8 KV
   pages. Every kernel launch counter is set to 0 just before each trace
   and read just after it; check output lengths, finish reasons,
   refcounts and that the path's kernels ran (paged attention once per
   layer, the calibrating norm 49 times and the static-params
   quantize+norm never per forward; at w8a8 also 169 int8 GEMM launches
   per forward, paged attention over int8 pools); then hold
   smoke-size engines on the card against the same engines on the CPU
   (bf16 exact and SOLE, w8a8 exact with float and int8 pages);
   then the same requests through the dense-slot ``Engine`` (batches of 8,
   384-column caches), in bf16 and at w8a8 with an int8 cache, with the
   launch counts per prefill or decode call checked (24 E2Softmax, 49
   calibrating norm, at w8a8 169 GEMM), and the smoke dense engine on the card
   against the CPU (SOLE, and w8a8 exact with an int8 cache); then the
   op layer's path: flash attention, the static-params SOLE norms, their
   residual and quantize-out twins (float32 and bf16 rows) and the codes
   norm through ``repro_torch.ops`` on CUDA tensors, and the port's
   quickstart
   ``main()``, with the counts read around them (every op-layer kernel,
   E2Softmax, the quantize+norm and, in the quickstart, the calibrating
   norm must launch; the model paths above
   must launch no op-layer kernel);
5. time each kernel and its plain version with CUDA events (L2 flushed
   before every launch), the kernel alone with ``torch.profiler``, beside
   the bound the card's memory rate or peak sets and, for the int8 GEMM,
   ``torch._int_mm`` (at M = 8 on the activation zero-padded to 24 rows:
   it refuses M <= 16), for exact-mode flash and exact-mode paged decode
   (on K/V gathered beforehand) ``scaled_dot_product_attention``
   (yardsticks the port never calls); the calibrating norm as the whole
   norm stage (the ``residual_*`` op call a model makes) by events and by
   the host's clock per call, beside the torch chain it replaces, and the
   dense path's ``_sole_probs`` stage likewise, with device kernels per
   call; the static-params norm kernels at every op-layer norm shape
   beside torch moving the same rows (``out.copy_(x)``, ``torch.add(x,
   r, out=h)``) as the bytes' floor; every static-params norm op (six
   ops, float32 and bf16 rows) as exactly one device kernel per call
   under the profiler, bitwise equal to its plain version, and the bf16
   op stage by events, host wall and device kernels per call;
6. profile one decode-heavy wave of the paged engine (bf16 and w8a8) and
   of the dense-slot engine (bf16 and w8a8): the device-busy share of the wall time,
   kernels per forward and the kernels with the most device time.

The relu2 + LayerNorm configs join phases 3-6: the paged kernel at
minitron_8b's attention (head dim 128, 32 heads over 8 KV heads; the
CUDA-core route, SOLE held to a share of rows) over bf16 and int8 pools,
the calibrating norm at LayerNorm widths 4,096 and 6,144, the int8 GEMM at
minitron_8b's shapes (K 16,384, the 256,000-entry head) and the dense
path's ``_sole_probs`` at its heads; then minitron_8b at full width (32
layers) through ``PagedEngine`` in bf16 and at w8a8 with int8 KV, through
the dense-slot ``Engine`` in bf16, three stochastic replays (exact mode;
cold, warm prefix cache, forced preemption; the device draws against the
host ``Sampler``), an 8,192-token prefill on the blocked attention against
the dense one, a profiled wave; and nemotron_4_15b (48 heads, 6,144
wide) through ``PagedEngine`` in bf16, each model freed before the next.

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
PREFILL_ROWS = 300                 # the dense path's checked prefill length
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
# the relu2 + LayerNorm configs at full width: minitron_8b's GEMMs (4096
# wide; up/down 16,384; the 256,000-entry LM head) and the LayerNorm
# widths of minitron_8b and nemotron_4_15b
MINITRON_GEMM_KN = (("wq_wo", 4096, 4096), ("wk_wv", 4096, 1024),
                    ("up", 4096, 16384), ("down", 16384, 4096),
                    ("head", 4096, 256000))
BLOCKED_PROMPT = 8192              # attn_impl "auto" takes the blocked path
STOCHASTIC = dict(temperature=0.8, top_k=40)
PREEMPT_BLOCKS = 40                # pages that force recompute-preemption


def gemm_per_forward(cfg) -> int:
    """int8 GEMM launches of one w8a8 forward: q, k, v, o and the MLP's
    projections (three gated, two otherwise) per layer, and the head."""
    mlp = 3 if cfg.mlp_kind in ("swiglu", "geglu") else 2
    return cfg.n_layers * (4 + mlp) + 1


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
    device work only, never the host's launch gaps. The warm-up runs the
    flush too: a kernel's first launch in a process may load it and wait
    for the device, which would drain the sleep."""
    for _ in range(3):
        flush()
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


def wall_ms(torch, fn, reps=100):
    """Host wall time per call of ``fn`` in a loop that ends in a
    synchronize: what a host-bound caller pays, launch overhead included."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def _device_us(event) -> float:
    for attr in ("device_time_total", "cuda_time_total"):
        if hasattr(event, attr):
            return float(getattr(event, attr))
    return 0.0


def sass_mma_counts(build):
    """Tensor-core instructions in the built kernels' SASS (``cuobjdump
    -sass``): per kernel function of the dense flash library, its
    ``HMMA...BF16`` count, and of the int8 GEMM library, its
    ``IMMA...S8`` count; None where the toolkit has no cuobjdump."""
    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    if not os.path.exists(tool):
        return None
    counts = {}
    for lib, kind, op in (("flash_e2softmax", "flash_e2softmax_", "HMMA"),
                          ("int8_matmul", "int8_matmul_kernel", "IMMA")):
        text = subprocess.run([tool, "-sass", str(build.library_path(lib))],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout
        for sec in text.split("Function : ")[1:]:
            fn, body = sec.split("\n", 1)
            if kind not in fn:
                continue
            ops = {}
            for tok in body.split():
                if tok.startswith(op + "."):
                    ops[tok.rstrip(";")] = ops.get(tok.rstrip(";"), 0) + 1
            counts[fn.strip()] = ops
    return counts


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

    for name, rows, c, rms in (("prefill", PREFILL_CHUNK, cfg.d_model, True),
                               ("decode", DECODE_BATCH, cfg.d_model, True),
                               ("layernorm_2048", PREFILL_CHUNK, 2048, False)):
        x = torch.randn((rows, c), generator=gen, device="cuda") * 3
        x[:, :: 7] *= 8                        # outlier channels, alpha > 0
        x = x.to(torch.bfloat16)
        gamma = 1 + 0.1 * torch.randn((c,), generator=gen, device="cuda")
        beta = 0.1 * torch.randn((c,), generator=gen, device="cuda")
        p = calibrate_ptf(x, unsigned=not rms)
        chan = (p.scale, p.alpha, gamma, None if rms else beta)
        # integer codes and sums are exact and the epilogue rounds like
        # the plain ops: bitwise, on the bf16 rows as they are (bf16 out
        # too) and on their float32 view
        ref = KN.qnorm_plain(x.float(), *chan, rms=rms)
        for rows_in, od in ((x.float(), torch.float32), (x, torch.float32),
                            (x, torch.bfloat16)):
            out = KN.qnorm(rows_in, *chan, rms=rms, out_dtype=od)
            torch.cuda.synchronize()
            if not torch.equal(out, ref.to(od)):
                raise AssertionError(f"ailayernorm_qnorm {name} "
                                     f"{rows_in.dtype} -> {od}: differs "
                                     "from the plain version")
        log(f"ailayernorm_qnorm {name} rows={rows} C={c} "
            f"{'rms' if rms else 'ln'}: bitwise equal to the plain version "
            "(float32 rows; bf16 rows, float32 and bf16 out)")
    return results


# (rows, C, rms) of the calibrating norm at the main paths' shapes: a decode
# step (8 rows), a paged prefill chunk (128), the dense engine's prefill of
# 8 lanes x 300 tokens (2400), all at qwen2_0_5b's width (RMS), and a
# prefill chunk at stablelm_1_6b's (LayerNorm, 2048)
CALIB_CASES = {"decode": (DECODE_BATCH, 896, True),
               "prefill": (PREFILL_CHUNK, 896, True),
               "dense_prefill": (DECODE_BATCH * 300, 896, True),
               "layernorm_2048": (PREFILL_CHUNK, 2048, False)}
# LayerNorm at minitron_8b's 4,096 and nemotron_4_15b's 6,144 channels, at
# the same three row counts
CALIB_CASES.update({f"ln{c}_{name}": (rows, c, False) for c in (4096, 6144)
                    for name, rows in (("decode", DECODE_BATCH),
                                       ("prefill", PREFILL_CHUNK),
                                       ("dense_prefill", DECODE_BATCH * 300))})


def check_calib_norm(torch):
    """Phase 3, the calibrating norm: residual add, PTF calibration over
    all rows and quantize+norm in one cluster launch, against the torch
    chain it replaces (its plain version) on bf16 activations: ``h``,
    ``alpha``, ``scale``, the bf16 output and the quantize-out codes and
    row scales bitwise, on two calls in a row."""
    from repro_torch.kernels import ailayernorm as KN
    gen = torch.Generator(device="cuda").manual_seed(3)
    res = {}
    for name, (rows, c, rms) in CALIB_CASES.items():
        x = torch.randn((rows, c), generator=gen, device="cuda") * 3
        x[:, ::7] *= 8                         # outlier channels, alpha > 0
        x = x.to(torch.bfloat16)
        r = torch.randn((rows, c), generator=gen, device="cuda").to(x.dtype)
        gamma = 1 + 0.1 * torch.randn((c,), generator=gen, device="cuda")
        beta = None if rms else 0.1 * torch.randn((c,), generator=gen,
                                                  device="cuda")
        plain_beta = torch.zeros_like(gamma) if rms else beta
        want = KN.calibrated_norm_plain(x, r, gamma, plain_beta, rms=rms,
                                        out_dtype=x.dtype)
        want_q = KN.calibrated_norm_plain(x, r, gamma, plain_beta, rms=rms,
                                          quant_out=True)
        for _ in range(2):
            got = KN.calibrated_norm(x, r, gamma, beta, rms=rms,
                                     out_dtype=x.dtype)
            got_q = KN.calibrated_norm(x, r, gamma, beta, rms=rms,
                                       quant_out=True)
            torch.cuda.synchronize()
            same = (all(torch.equal(a, b) for a, b in zip(got, want))
                    and torch.equal(got_q[0], want[0])
                    and all(torch.equal(a, b)
                            for a, b in zip(got_q[1], want_q[1]))
                    and torch.equal(got_q[2], want[2])
                    and torch.equal(got_q[3], want[3]))
            if not same:
                raise AssertionError(f"ailayernorm_calib {name}: not bitwise "
                                     "equal to the torch chain")
        res[name] = dict(x=x, r=r, gamma=gamma, beta=beta, rms=rms,
                         max_abs_err=0.0)
        log(f"ailayernorm_calib {name} rows={rows} C={c} "
            f"{'rms' if rms else 'ln'}: h, alpha, scale, bf16 out, int8 "
            f"codes and row scales bitwise equal (scale "
            f"{want[3].item():.6g}, alpha histogram "
            f"{torch.bincount(want[2], minlength=4).tolist()})")
    return res


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
    exact) at every path shape (M = decode_batch or prefill_chunk), two
    ragged ones and four whose K splits are uneven (M = 1 at down's K; K
    not a multiple of 64 x splits, with and without 16-byte loads; N % 4
    != 0), on random codes with one all-127 row and column (the largest
    sums); each shape twice in a row, so the split's self-resetting
    tickets must leave no state behind. Every path shape must launch at
    least one CTA per SM."""
    from repro_torch.kernels import int8_matmul as KM
    gen = torch.Generator(device="cuda").manual_seed(2)
    shapes = [(f"{pre}{nm}_m{m}", m, k, n)
              for pre, kn in (("", GEMM_KN), ("minitron_", MINITRON_GEMM_KN))
              for m in (DECODE_BATCH, PREFILL_CHUNK) for nm, k, n in kn]
    n_path = len(shapes)
    shapes += [("ragged_7x130x33", 7, 130, 33),
               ("ragged_64x256x128", 64, 256, 128),
               ("uneven_down_m1", 1, 4864, 896),
               ("uneven_8x1008x896", 8, 1008, 896),
               ("uneven_8x1000x896", 8, 1000, 896),
               ("uneven_8x896x130", 8, 896, 130)]
    results = {}
    for i, (name, m, k, n) in enumerate(shapes):
        x = torch.randint(-127, 128, (m, k), generator=gen, device="cuda",
                          dtype=torch.int8)
        w = torch.randint(-127, 128, (k, n), generator=gen, device="cuda",
                          dtype=torch.int8)
        x[0] = 127
        w[:, 0] = 127
        ref = KM.int8_matmul_plain(x, w)
        plan = KM.split_plan(m, n, k)
        for call in (1, 2):
            out = KM.int8_matmul(x, w)
            torch.cuda.synchronize()
            if out.dtype != torch.int32 or not torch.equal(out, ref):
                bad = (out != ref).sum().item()
                raise AssertionError(f"int8_matmul {name} ({m}x{k}x{n}), "
                                     f"call {call}: {bad} of {out.numel()} "
                                     "outputs differ")
        if i < n_path and plan.ctas < KM.MIN_CTAS:
            raise AssertionError(f"int8_matmul {name}: {plan.ctas} CTAs")
        bm, bn = KM.TILES[plan.tile]
        results[name] = dict(x=x, w=w, max_abs_err=0.0,
                             plan=f"tile {bm}x{bn}, {plan.splits} K splits, "
                                  f"{plan.ctas} CTAs")
        log(f"int8_matmul {name} {m}x{k}x{n}: bitwise equal on two calls; "
            f"{results[name]['plan']}")
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

    stage = dense_stage_inputs(torch, cfg, gen)
    dmask = stage["decode"]["mask"].reshape(8 * h, t + 1)
    s = PREFILL_ROWS
    pmask = stage["prefill"]["mask"].reshape(8 * h * s, s)
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
    results["stage"] = check_sole_probs(torch, cfg, stage)
    results["stage_inputs"] = stage
    return results


def dense_stage_inputs(torch, cfg, gen):
    """The dense-slot path's ``_sole_probs`` inputs at qwen2_0_5b's width:
    raw float32 logits and the mask as the path hands it over. Decode: 8
    lanes, the (B, KV, g, T+1) logits against the 384-column cache plus
    the current token, the mask concatenated (a lane sees its columns up
    to a per-lane length, never the write slot); prefill: 8 lanes of 300
    tokens with per-lane left padding, the (B, 1, S, S) causal mask
    broadcast over the 14 heads (stride 0)."""
    dev = gen.device
    b, h, kvh, t = DECODE_BATCH, cfg.n_heads, cfg.n_kv_heads, DENSE_MAX_LEN
    lens = torch.tensor([49, 300, 117, 1, 256, 83, 160, 1], device=dev)
    cols = torch.arange(t, device=dev)
    valid = (cols[None] < lens[:, None]) & (cols[None] != 48)
    dmask = torch.cat(
        [torch.broadcast_to(valid[:, None, None, :], (b, kvh, h // kvh, t)),
         torch.ones((b, kvh, h // kvh, 1), dtype=torch.bool, device=dev)], -1)
    s = PREFILL_ROWS
    n_pad = torch.tensor([252, 0, 180, 100, 196, 136, 220, 50], device=dev)
    pos = torch.arange(s, device=dev)
    local = pos[None] - n_pad[:, None]
    kpos = torch.where(local < 0, 2 ** 30, local)
    qpos = torch.clamp_min(local, 0)
    pmask = (kpos[:, None, :] < 2 ** 29) & (qpos[:, :, None] >= kpos[:, None])
    pmask = torch.broadcast_to(pmask[:, None], (b, h, s, s))
    return {name: dict(logits=torch.randn(mask.shape, generator=gen,
                                          device=dev) * 4, mask=mask)
            for name, mask in (("decode", dmask), ("prefill", pmask))}


def sole_probs_chain(torch, cfg, logits, mask, e2):
    """The dense path's SOLE probabilities as the chain the one op call
    replaced: the masked max, subtract, ``snap_logits``, E2Softmax ``e2``
    (the plain version or the kernel) on the mask made contiguous at the
    logits' shape, then the cast to bf16."""
    from repro_torch import ops
    from repro_torch.models.layers import LOGIT_INT8_SCALE
    m = torch.where(mask, logits, -torch.inf).amax(-1, keepdim=True)
    d = ops.snap_logits(logits - torch.clamp_min(m, -1e30),
                        LOGIT_INT8_SCALE if cfg.logit_int8 else None)
    full = torch.broadcast_to(mask, logits.shape).contiguous()
    return e2(d, mask=full, exp_bits=cfg.exp_bits).to(torch.bfloat16)


def device_kernels(torch, fn, reps=5, wrappers=None, ours=None):
    """The device kernels (and copies) one call of ``fn`` issues: torch's
    by ``torch.profiler`` over ``reps`` calls between two marker kernels
    (``torch.cuda._sleep``, not counted), the port's kernels (``ours``: a
    test of a profiler key; the E2Softmax kernel by default) by their
    wrappers' launch counters (the profiler can drop a record of a kernel
    launched through ctypes: it kept 4 of 5 in one window). Returns
    (kernels per call, the other kernels' names, records of ours the
    profiler kept)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import e2softmax as KE
    wrappers = wrappers or (KE.e2softmax,)
    ours = ours or is_dense_e2
    fn()
    torch.cuda.synchronize()
    n0 = sum(w.launches for w in wrappers)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        for _ in range(reps):
            fn()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    launched = sum(w.launches for w in wrappers) - n0
    rows = [(e.key, e.count) for e in prof.key_averages()
            if _device_us(e) > 0 and "spin_kernel" not in e.key]
    seen = sum(n for k, n in rows if ours(k))
    other = [(k, n) for k, n in rows if not ours(k)]
    return ((sum(n for _, n in other) + launched) / reps,
            [k[:80] for k, _ in other], seen)


def check_sole_probs(torch, cfg, stage):
    """Phase 3, the dense path's SOLE probabilities: ``layers._sole_probs``
    (one ``softmax`` ``sole`` op call with ``int8_scale`` and bf16 out) at
    the decode and prefill inputs, bitwise equal to the chain it replaced
    on its plain pieces, one ``e2softmax`` launch and exactly one device
    kernel per call (``torch.profiler``)."""
    from repro_torch.kernels import e2softmax as KE
    from repro_torch.models import layers as L
    out = {}
    for name, inp in stage.items():
        logits, mask = inp["logits"], inp["mask"]
        before = KE.e2softmax.launches
        probs = L._sole_probs(logits, mask, cfg, torch.bfloat16)
        if KE.e2softmax.launches != before + 1:
            raise AssertionError(f"_sole_probs {name}: "
                                 f"{KE.e2softmax.launches - before} launches")
        want = sole_probs_chain(torch, cfg, logits, mask, KE.e2softmax_plain)
        torch.cuda.synchronize()
        if probs.dtype != torch.bfloat16 or not torch.equal(probs, want):
            raise AssertionError(f"_sole_probs {name}: differs from the chain")
        kw = dict(mask=mask, exp_bits=cfg.exp_bits, out_dtype=torch.bfloat16,
                  int8_scale=L.LOGIT_INT8_SCALE)
        if not torch.equal(KE.e2softmax(logits, **kw),
                           KE.e2softmax_plain(logits, **kw)):
            raise AssertionError(f"e2softmax {name}: the strided mask and "
                                 "bf16 out differ from the plain version")
        n, others, seen = device_kernels(
            torch, lambda: L._sole_probs(logits, mask, cfg, torch.bfloat16))
        if n != 1 or others or not seen:
            raise AssertionError(f"_sole_probs {name}: {n} device kernels "
                                 f"per call, others {others}, {seen} "
                                 "E2Softmax records")
        out[name] = dict(device_kernels=n)
        log(f"_sole_probs {name} logits {tuple(logits.shape)} mask strides "
            f"{mask.stride()}: bitwise equal to the chain (and the kernel, "
            f"bf16 out, to its plain version), one launch, {n:.0f} device "
            f"kernel per call (the profiler kept {seen} of its 5 records and "
            "saw no other kernel)")
    return out


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
            "ailayernorm_codes": KN.codes_norm,
            "ailayernorm_calib": KN.calibrated_norm}


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
    At w8a8 also checks ``gemm_per_forward`` int8 GEMM launches per
    forward (one paged attention launch per layer marks a forward) and
    int8 page pools, and reports the peak device memory of the trace."""
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
    path_kernels = (("paged_e2softmax", "ailayernorm_calib", "int8_matmul")
                    if w8a8 else ("paged_e2softmax", "ailayernorm_calib"))
    for name in path_kernels:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the path")
    forwards, rest = divmod(launches["paged_e2softmax"], cfg.n_layers)
    if rest:
        raise AssertionError(f"{launches['paged_e2softmax']} attention "
                             f"launches are not whole forwards")
    # one calibrating-norm launch per norm (2 per layer and the final
    # one), and never the static-params quantize+norm
    if launches["ailayernorm_calib"] != (2 * cfg.n_layers + 1) * forwards:
        raise AssertionError(
            f"{launches['ailayernorm_calib']} calibrating-norm launches over "
            f"{forwards} forwards, not {2 * cfg.n_layers + 1} each")
    if launches["ailayernorm_qnorm"]:
        raise AssertionError("the paged path launched the static-params "
                             "quantize+norm")
    if w8a8:
        if launches["int8_matmul"] != gemm_per_forward(cfg) * forwards:
            raise AssertionError(
                f"{launches['int8_matmul']} int8 GEMM launches over "
                f"{forwards} forwards, not {gemm_per_forward(cfg)} each")
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
    calibrating norm kernel 49 times (the static-params quantize+norm
    never) and, at w8a8, the int8 GEMM 169 times, and never
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
                     "ailayernorm_calib": (2 * cfg.n_layers + 1) * calls,
                     "ailayernorm_qnorm": 0,
                     "int8_matmul": (gemm_per_forward(cfg) * calls
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


def case_dims(case):
    """(H, KV, d) of a paged case: q (B, H, C, d), pools (N, bs, KV, d)."""
    return case[0].shape[1], case[1].shape[2], case[0].shape[3]


def time_kernels(torch, attn, launches, cfg):
    """Phase 5: CUDA-event times of the paged kernel and its plain
    version, and the kernel's own device time from ``torch.profiler``, at
    each checked shape (its heads and head dim from the case); every
    shape also in exact mode beside ``scaled_dot_product_attention``."""
    from repro_torch.kernels import flash_e2softmax as KA
    from repro_torch.models.layers import LOGIT_INT8_SCALE
    flush_buf = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    flush = flush_buf.zero_
    kw = dict(sole=True, exp_bits=cfg.exp_bits, int8_scale=LOGIT_INT8_SCALE)
    table = []
    entry = {"paged_e2softmax": dict(
        name="paged_e2softmax", route="cuda",
        source="src/repro_torch/kernels/csrc/paged_e2softmax.cu",
        replaces="src/repro/kernels/flash_e2softmax.py:186", shapes={})}
    for name, res in attn.items():
        case, causal = res["case"], res["causal"]
        h, kvh, d = case_dims(case)
        kvmap = KA.default_kv_head_map(h, kvh, "cuda")

        def run():
            return KA.flash_e2softmax_paged(*case, causal=causal, **kw)
        ms = time_ms(torch, run, flush)
        kernel_ms = profiled_kernel_ms(torch, run, flush, "paged_e2softmax")
        plain = time_ms(torch, lambda: KA.flash_e2softmax_paged_plain(
            *case, kvmap, causal=causal, **kw), flush, reps=5)
        nbytes, flops = attention_work(case, causal, h, kvh, d)
        bms, by = bound_ms(nbytes, flops, BF16_FLOPS)
        exact_ms, sdpa_ms = paged_exact_vs_sdpa(torch, case, kvmap, flush,
                                                causal)
        entry["paged_e2softmax"]["shapes"][name] = dict(
            shape=f"q {tuple(case[0].shape)} KV {kvh} kv_len "
                  f"{case[4][:, 1].tolist()}",
            variant=KA.paged_variant(case[0].dtype, case[1].dtype, d,
                                     case[1].shape[1]),
            ms=ms, kernel_ms=kernel_ms, plain_ms=plain, bound_ms=bms,
            bound_by=by,
            max_abs_err=res["max_abs_err"],
            max_abs_err_random=res["max_abs_err_random"],
            exact_ms=exact_ms, library_ms=sdpa_ms,
            library="scaled_dot_product_attention (exact, K/V gathered)",
            bytes=nbytes, flops=flops)
    for key, e in entry.items():
        main = e["shapes"]["decode"]            # the most-launched shape
        e.update(launches=launches[key], max_abs_err=max(
            s["max_abs_err"] for s in e["shapes"].values()),
            ms=main["ms"], plain_ms=main["plain_ms"],
            bound_ms=main["bound_ms"], bound_by=main["bound_by"],
            library_ms=main.get("library_ms"), library=main.get("library"))
        table.append(e)
    for e in table:
        for s, v in e["shapes"].items():
            k = v["kernel_ms"]
            log(f"{e['name']} {s} [{v['shape']}; {v['variant']}]: "
                f"{v['ms'] * 1e3:.1f} us (profiler: kernel "
                f"{'not measured' if k is None else f'{k * 1e3:.1f} us'}; "
                f"plain {v['plain_ms'] * 1e3:.1f} us, bound "
                f"{v['bound_ms'] * 1e3:.2f} us by {v['bound_by']})"
                f"; exact mode {v['exact_ms'] * 1e3:.1f} us, "
                f"{v['library']} {v['library_ms'] * 1e3:.1f} us")
    return table


def paged_exact_vs_sdpa(torch, case, kvmap, flush, causal=False):
    """The paged kernel in exact mode on a case, and
    ``scaled_dot_product_attention`` on the same K/V gathered contiguous
    beforehand (the gather is not timed; padded to the longest sequence,
    with a key mask that is also causal for a prefill chunk): a
    yardstick the port never calls."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_e2softmax as KA
    q, k_pool, v_pool, tables, meta = case
    b, h, c, d = q.shape
    kv_lens = meta[:, 1].tolist()
    t = max(kv_lens)
    pages = tables[:, :-(-t // BLOCK_SIZE)].long()
    rows = kvmap.long()
    dt = torch.bfloat16

    def gather(pool):                       # (B, H, T, d) per query head
        g = pool[pages].flatten(1, 2)[:, :t]            # (B, T, KV, d)
        return g[:, :, rows].transpose(1, 2).to(dt).contiguous()
    k4, v4 = gather(k_pool), gather(v_pool)
    cols = torch.arange(t, device=q.device)
    mask = (cols[None, :] < meta[:, 1:2].long())[:, None, None, :]
    if causal:
        qpos = meta[:, :1].long() + torch.arange(c, device=q.device)
        mask = mask & (cols[None, None, :] <= qpos[:, :, None])[:, None]
    exact = time_ms(torch, lambda: KA.flash_e2softmax_paged(
        *case, causal=causal, sole=False, exp_bits=4), flush)
    sdpa = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k4, v4, attn_mask=mask), flush)
    return exact, sdpa


def time_calib_norm(torch, calib, launches):
    """Phase 5 for the calibrating norm: the norm stage, the whole
    ``residual_rmsnorm``/``residual_layernorm`` op call as a model's
    ``apply_residual_norm`` makes it (bf16 out), timed with CUDA events
    (device time) and with the host's clock per call (what the host-bound
    path pays), beside its plain version (the torch chain it replaces) and
    the kernel alone from the profiler; bound: the bytes of x, r, h and
    the output at the memory rate."""
    from repro_torch import ops
    from repro_torch.kernels import ailayernorm as KN
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda").zero_
    e = dict(name="ailayernorm_calib", route="cuda",
             source="src/repro_torch/kernels/csrc/ailayernorm.cu",
             replaces="src/repro/kernels/ailayernorm.py:305", shapes={})
    for name, res in calib.items():
        x, r, gamma, beta, rms = (res[k] for k in ("x", "r", "gamma", "beta",
                                                   "rms"))
        kind = "rmsnorm" if rms else "layernorm"
        stage = ops.resolve(f"residual_{kind}", "sole", "cuda")
        extra = () if rms else (beta,)
        plain_beta = torch.zeros_like(gamma) if rms else beta

        def run():
            return stage(x, r, gamma, *extra, out_dtype=x.dtype)

        def plain():
            return KN.calibrated_norm_plain(x, r, gamma, plain_beta, rms=rms,
                                            out_dtype=x.dtype)
        rows, c = x.shape
        nbytes = 4 * rows * c * x.element_size() + 2 * c * 4
        bms, by = bound_ms(nbytes, QNORM_OPS_PER_ELEMENT * rows * c,
                           FP32_FLOPS)
        e["shapes"][name] = dict(
            shape=f"rows {rows} C {c} {'rms' if rms else 'ln'} bf16",
            ms=time_ms(torch, run, flush),
            kernel_ms=profiled_kernel_ms(torch, run, flush,
                                         "calib_norm_kernel"),
            plain_ms=time_ms(torch, plain, flush, reps=10),
            wall_ms=wall_ms(torch, run), plain_wall_ms=wall_ms(torch, plain),
            bound_ms=bms, bound_by=by, max_abs_err=res["max_abs_err"],
            bytes=nbytes)
    main = e["shapes"]["decode"]
    e.update(launches=launches["ailayernorm_calib"], max_abs_err=0.0,
             ms=main["ms"], plain_ms=main["plain_ms"],
             bound_ms=main["bound_ms"], bound_by=main["bound_by"],
             library_ms=None)
    for s, v in e["shapes"].items():
        k = v["kernel_ms"]
        log(f"ailayernorm_calib stage {s} [{v['shape']}]: events "
            f"{v['ms'] * 1e3:.1f} us, host wall {v['wall_ms'] * 1e3:.1f} us "
            f"(profiler: kernel "
            f"{'not measured' if k is None else f'{k * 1e3:.1f} us'}; plain "
            f"chain {v['plain_ms'] * 1e3:.1f} us events, "
            f"{v['plain_wall_ms'] * 1e3:.1f} us wall; bound "
            f"{v['bound_ms'] * 1e3:.2f} us by {v['bound_by']})")
    return e


def distinct_bytes(t) -> int:
    """Bytes of the distinct elements of ``t`` (a broadcast view counts
    its stride-0 dims once)."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n * t.element_size()


def time_e2softmax(torch, e2, launches, launches8):
    """Phase 5 for the E2Softmax kernel: CUDA-event and profiler times at
    the path's decode and prefill shapes and the two benchmark shapes on
    snapped float32 logits with a contiguous mask and float32 out (the
    kernel alone, as the chain called it), the plain version's time, and the bound: the logits and
    mask read once and the output written once at the card's memory rate
    (the ~16 operations per element are far below its peak). Then the
    dense path's whole ``_sole_probs`` stage at decode and prefill (raw
    logits, the path's mask, bf16 out): the one launch against the chain
    it replaced (the torch ops around this kernel), each by events,
    host wall per call and device kernels per call; bound: the logits,
    the distinct mask bytes and the bf16 output once."""
    from repro_torch.kernels import e2softmax as KE
    from repro_torch.models import layers as L
    from repro_torch.configs.base import get_config
    cfg = get_config("qwen2_0_5b")
    flush_buf = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    flush = flush_buf.zero_
    entry = dict(name="e2softmax", route="cuda",
                 source="src/repro_torch/kernels/csrc/e2softmax.cu",
                 replaces="src/repro/kernels/e2softmax.py:48", shapes={},
                 stage={})
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
            kernel_ms=profiled_kernel_ms(torch, run, flush, "e2softmax"),
            plain_ms=time_ms(torch, lambda: KE.e2softmax_plain(x, **kw),
                             flush, reps=10),
            bound_ms=bms, bound_by=by, max_abs_err=res["max_abs_err"],
            rows_off=res["rows_off"], bytes=nbytes)
    for name, inp in e2["stage_inputs"].items():
        logits, mask = inp["logits"], inp["mask"]

        def one():
            return L._sole_probs(logits, mask, cfg, torch.bfloat16)

        def chain():
            return sole_probs_chain(torch, cfg, logits, mask, KE.e2softmax)
        nbytes = (logits.numel() * 4 + distinct_bytes(mask)
                  + logits.numel() * 2)
        bms, by = bound_ms(nbytes, E2_OPS_PER_ELEMENT * logits.numel(),
                           FP32_FLOPS)
        entry["stage"][name] = dict(
            shape=f"logits {tuple(logits.shape)} f32, mask strides "
                  f"{tuple(mask.stride())}, bf16 out",
            ms=time_ms(torch, one, flush),
            kernel_ms=profiled_kernel_ms(torch, one, flush, "e2softmax"),
            wall_ms=wall_ms(torch, one),
            kernels_per_call=device_kernels(torch, one)[0],
            chain_ms=time_ms(torch, chain, flush),
            chain_wall_ms=wall_ms(torch, chain),
            chain_kernels_per_call=device_kernels(torch, chain)[0],
            bound_ms=bms, bound_by=by, bytes=nbytes)
    top = entry["shapes"]["decode"]            # the most-launched shape
    entry.update(launches=launches["e2softmax"],
                 launches_w8a8=launches8["e2softmax"],
                 max_abs_err=max(v["max_abs_err"] for k, v in e2.items()
                                 if k in entry["shapes"]),
                 ms=top["ms"], plain_ms=top["plain_ms"],
                 bound_ms=top["bound_ms"], bound_by=top["bound_by"],
                 library_ms=None, main_shape="decode")
    for sname, v in entry["shapes"].items():
        k = v["kernel_ms"]
        log(f"e2softmax {sname} [{v['shape']}]: {v['ms'] * 1e3:.2f} us "
            f"(profiler: kernel "
            f"{'not measured' if k is None else f'{k * 1e3:.2f} us'}; "
            f"plain {v['plain_ms'] * 1e3:.1f} us, bound "
            f"{v['bound_ms'] * 1e3:.3f} us by {v['bound_by']})")
    for sname, v in entry["stage"].items():
        k = v["kernel_ms"]
        log(f"_sole_probs stage {sname} [{v['shape']}]: one launch "
            f"{v['ms'] * 1e3:.2f} us events (profiler: kernel "
            f"{'not measured' if k is None else f'{k * 1e3:.2f} us'}), "
            f"host wall {v['wall_ms'] * 1e3:.1f} us, "
            f"{v['kernels_per_call']} device kernel(s); chain "
            f"{v['chain_ms'] * 1e3:.2f} us events, host wall "
            f"{v['chain_wall_ms'] * 1e3:.1f} us, "
            f"{v['chain_kernels_per_call']} device kernels; bound "
            f"{v['bound_ms'] * 1e3:.3f} us by {v['bound_by']}")
    return [entry]


INT_MM_MIN_M = 24      # torch._int_mm refuses M <= 16


def _int_mm_ms(torch, x, w, flush):
    """``torch._int_mm`` (cuBLAS) on the same inputs, the yardstick:
    (ms, note), or (None, why it refused). It refuses M <= 16, so a decode
    activation is zero-padded to M = 24 rows first (outside the timing;
    the first M rows of the product are the exact product). The port never
    calls it."""
    from repro_torch.kernels.int8_matmul import int8_matmul_plain
    m = x.shape[0]
    xp = x
    note = "torch._int_mm"
    if m < INT_MM_MIN_M:
        xp = torch.zeros((INT_MM_MIN_M, x.shape[1]), dtype=x.dtype,
                         device=x.device)
        xp[:m] = x
        note += f" on x zero-padded from M = {m} to {INT_MM_MIN_M}"
    try:
        exact = torch.equal(torch._int_mm(xp, w)[:m], int8_matmul_plain(x, w))
    except RuntimeError as e:
        return None, "torch._int_mm refuses: " + str(e).strip()[:120]
    ms = time_ms(torch, lambda: torch._int_mm(xp, w), flush)
    return ms, note + ("" if exact else ", NOT equal to the exact product")


def time_w8a8_kernels(torch, attn8, gemm, launches, cfg):
    """Phase 5 for the w8a8 path: the paged kernel over int8 pools (SOLE,
    ``quant_pv``, as the path runs it) and the int8 GEMM at every path
    shape, timed like the bf16 kernels; launches from the w8a8 trace."""
    from repro_torch.kernels import flash_e2softmax as KA
    from repro_torch.kernels import int8_matmul as KM
    from repro_torch.models.layers import KV_INT8_SCALE, LOGIT_INT8_SCALE
    flush_buf = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    flush = flush_buf.zero_
    kw = dict(sole=True, exp_bits=cfg.exp_bits, int8_scale=LOGIT_INT8_SCALE,
              kv_scale=KV_INT8_SCALE, quant_pv=True)
    paged = dict(name="paged_e2softmax_int8kv", route="cuda",
                 source="src/repro_torch/kernels/csrc/paged_e2softmax.cu",
                 replaces="src/repro/kernels/flash_e2softmax.py:186",
                 shapes={})
    for name, res in attn8.items():
        case, causal = res["case"], res["causal"]
        h, kvh, d = case_dims(case)
        kvmap = KA.default_kv_head_map(h, kvh, "cuda")

        def run():
            return KA.flash_e2softmax_paged(*case, causal=causal, **kw)
        nbytes, flops = attention_work(case, causal, h, kvh, d)
        bms, by = bound_ms(nbytes, flops, BF16_FLOPS)
        paged["shapes"][name] = dict(
            shape=f"q {tuple(case[0].shape)} KV {kvh} int8 pools kv_len "
                  f"{case[4][:, 1].tolist()}",
            variant=KA.paged_variant(case[0].dtype, case[1].dtype, d,
                                     case[1].shape[1], KV_INT8_SCALE),
            ms=time_ms(torch, run, flush),
            kernel_ms=profiled_kernel_ms(torch, run, flush, "paged_e2softmax"),
            plain_ms=time_ms(torch, lambda: KA.flash_e2softmax_paged_plain(
                *case, kvmap, causal=causal, **kw), flush, reps=5),
            bound_ms=bms, bound_by=by, max_abs_err=res["max_abs_err"],
            bytes=nbytes, flops=flops)
    mm = dict(name="int8_matmul", route="cuda",
              source="src/repro_torch/kernels/csrc/int8_matmul.cu",
              replaces="src/repro/kernels/int8_matmul.py:29", shapes={})
    for name, res in gemm.items():
        if name.startswith(("ragged", "uneven")):
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
            plan=res["plan"], max_abs_err=0.0, bytes=nbytes,
            ops=2 * m * k * n)
    # the most-launched shapes: a decode step; for the GEMM its largest,
    # the LM head
    for e, key, main in ((paged, "paged_e2softmax", "decode"),
                         (mm, "int8_matmul", f"head_m{DECODE_BATCH}")):
        top = e["shapes"][main]
        e.update(launches=launches[key], max_abs_err=max(
            v["max_abs_err"] for v in e["shapes"].values()),
            ms=top["ms"], plain_ms=top["plain_ms"], bound_ms=top["bound_ms"],
            bound_by=top["bound_by"], library_ms=top.get("library_ms"),
            library=top.get("library"), main_shape=main)
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
# attention at 2048 tokens, a ragged non-causal case, stablelm_1_6b's MHA;
# a causal case whose last k-block (104 keys) is not a multiple of 16, one
# shorter than 16 rows, and one at head dim 128 (d^-1/2 not a power of
# two, so held to a share of rows). bf16 inputs run the tensor-core
# kernel; "_f32" cases take qwen2's inputs in float32 (the CUDA-core
# kernel).
FLASH_CASES = {"qwen2_causal": (1, 2048, 2048, 14, 2, 64, True),
               "ragged_noncausal": (2, 300, 1000, 14, 2, 64, False),
               "stablelm_mha": (1, 2048, 2048, 32, 32, 64, True),
               "causal_1000": (1, 1000, 1000, 14, 2, 64, True),
               "short_8": (2, 8, 8, 14, 2, 64, True),
               "hd_128": (1, 1024, 1024, 8, 8, 128, True),
               "qwen2_causal_f32": (1, 2048, 2048, 14, 2, 64, True)}
# each flash check: every case in every mode. "sole_int8" snaps the logits
# to the path's int8 grid, "sole_exact_corr" rescales by the float32
# correction
FLASH_MODES = tuple((c, m) for c in FLASH_CASES
                    for m in ("sole", "sole_int8", "sole_exact_corr", "exact"))
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
        if name.endswith("_f32"):
            continue
        flash[name] = dict(q=(randint(-8, 9, (b, s, h, hd)) / 4).to(bf),
                           k=randint(-8, 9, (b, t, kvh, hd)).to(bf),
                           v=randn(b, t, kvh, hd).to(bf), causal=causal)
    for name in FLASH_CASES:
        if name.endswith("_f32"):
            base = flash[name[:-4]]
            flash[name] = dict(base, **{x: base[x].float()
                                        for x in ("q", "k", "v")})
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


def norm_args(case, dtype=None):
    """x, r and the static params' channel arguments of a norm case, the
    rows in ``dtype`` (as made, float32, by default)."""
    p = case["params"]
    x, r = (case[k] if dtype is None else case[k].to(dtype) for k in "xr")
    return (x, r, p.scale, p.alpha, case["gamma"],
            None if case["rms"] else case["beta"])


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
    folded = {}
    for name, mode in FLASH_MODES + (("qwen2_random", "sole_int8"),):
        case = inp["flash"][name]
        if name not in folded:
            folded[name] = _fold(torch, case)
        args = folded[name]
        kkw = _flash_kw(mode, case["causal"])
        out = KA.flash_e2softmax(*args, **kkw)
        ref = KA.flash_e2softmax_plain(*args, **kkw)
        torch.cuda.synchronize()
        if not torch.isfinite(out).all():
            raise AssertionError(f"flash_e2softmax {name} {mode}: non-finite")
        err = (out - ref).abs()
        scale = max(ref.abs().max().item(), 1.0)
        variant = KA.dense_variant(args[0].dtype)
        if case["q"].shape[-1] == 128:
            # d^-1/2 is no power of two: the scaled q (plain) and the
            # scaled logits (kernel) round apart, and a code may flip at a
            # tie: at most 1% of rows off by more than 1e-3
            off = (err.amax(-1) > 1e-3 * scale).float().mean().item()
            if off > 0.01:
                raise AssertionError(f"flash_e2softmax {name} {mode}: {off}"
                                     " of rows off by > 1e-3")
            res["flash"][f"{name}_{mode}"] = dict(
                name=name, mode=mode, max_abs_err=err.max().item(),
                rows_off=off, args=args, kkw=kkw, out=out, variant=variant)
            log(f"flash_e2softmax {name} {mode} [{variant}]: max|err| "
                f"{err.max().item():.3e}, rows off {off:.5f}")
            continue
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
            kkw=kkw, out=out, variant=variant)
        log(f"flash_e2softmax {name} {mode} q {tuple(case['q'].shape)} "
            f"kv {tuple(case['k'].shape)} [{variant}]: max|err| "
            f"{err.max().item():.3e}")
    bf = torch.bfloat16
    for name, case in inp["norms"].items():
        args, rms = norm_args(case), case["rms"]
        x, r, chan = args[0], args[1], args[2:]
        out_q = KN.qnorm(x, *chan, rms=rms)
        h, out = KN.add_norm(*args, rms=rms)
        h8, codes, scale = KN.add_norm_quant(*args, rms=rms)
        # bf16 rows read as they are (bf16 out for the norms)
        bargs = norm_args(case, bf)
        xb, rb = bargs[:2]
        bout_q = KN.qnorm(xb, *chan, rms=rms, out_dtype=bf)
        bh, bout = KN.add_norm(*bargs, rms=rms, out_dtype=bf)
        bh8, bcodes, bscale = KN.add_norm_quant(*bargs, rms=rms)
        want = dict(
            out_q=KN.qnorm_plain(x, *chan, rms=rms),
            add_norm=KN.add_norm_plain(*args, rms=rms),
            add_norm_quant=KN.add_norm_quant_plain(*args, rms=rms),
            bf16_out_q=KN.qnorm_plain(xb.float(), *chan, rms=rms).to(bf),
            bf16_add_norm=KN.add_norm_plain(xb.float(), rb.float(), *chan,
                                            rms=rms),
            bf16_add_norm_quant=KN.add_norm_quant_plain(
                xb.float(), rb.float(), *chan, rms=rms))
        want["bf16_add_norm"] = (want["bf16_add_norm"][0],
                                 want["bf16_add_norm"][1].to(bf))
        got = dict(out_q=out_q, add_norm=(h, out),
                   add_norm_quant=(h8, codes, scale), bf16_out_q=bout_q,
                   bf16_add_norm=(bh, bout),
                   bf16_add_norm_quant=(bh8, bcodes, bscale))
        torch.cuda.synchronize()
        # every output bitwise equal to its plain version on the float32
        # view of the same rows (then cast to bf16 where it is written so)
        for key, g in got.items():
            g = g if isinstance(g, tuple) else (g,)
            w = want[key] if isinstance(want[key], tuple) else (want[key],)
            if not all(a.dtype == b.dtype and torch.equal(a, b)
                       for a, b in zip(g, w)):
                raise AssertionError(f"static-params norm {name} {key}: "
                                     "differs from the plain version")
        if not torch.isfinite(out).all():
            raise AssertionError(f"add_norm {name}: non-finite output")
        if not all(torch.equal(a, b) for a, b in zip((codes, scale),
                                                     quantize_act(out))):
            raise AssertionError(f"add_norm_quant {name}: codes or scale "
                                 "differ from quantize_act of add_norm")
        res["norms"][name] = dict(
            max_abs_err=0.0, args=args, bargs=bargs, rms=rms, out_q=out_q,
            h=h, out=out, codes=codes, scale=scale, bout_q=bout_q, bh=bh,
            bout=bout, bh8=bh8, bcodes=bcodes, bscale=bscale)
        log(f"ailayernorm static {name}: qnorm, add_norm (h and out) and "
            "add_norm_quant (h, codes, scale) bitwise equal to the plain "
            "versions on float32 rows and on bf16 rows (bf16 out), the "
            "codes = quantize_act(add_norm)")
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
        # float32 rows, float32 out; then bf16 rows, bf16 out
        for tag, (x, r) in (("", (case["x"], case["r"])),
                            ("b", res["norms"][name]["bargs"][:2])):
            od = {} if not tag else dict(out_dtype=x.dtype)
            outs[f"{tag}norm_{name}"] = getattr(ops, f"{kind}_fn")(
                "sole", dev)(x, case["gamma"], *extra, params=p, **od)
            outs[f"{tag}res_{name}"] = ops.residual_norm_fn(
                kind, "sole", dev)(x, r, case["gamma"], *extra, params=p,
                                   **od)
            outs[f"{tag}resq_{name}"] = ops.residual_norm_q_fn(
                kind, "sole", dev)(x, r, case["gamma"], *extra, params=p)
    cd = inp["codes"]
    outs["codes"] = KN.ailayernorm_codes(cd["xi"], cd["alpha"], cd["gamma"],
                                         cd["beta"])
    if quickstart.main([]) != 0:
        raise AssertionError("quickstart failed")
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = read_launches()
    want_zero = ("paged_e2softmax", "int8_matmul")
    for k in OPS_KERNELS + ("e2softmax", "ailayernorm_qnorm",
                            "ailayernorm_calib"):
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} never launched on the op path")
    if any(launches[k] for k in want_zero):
        raise AssertionError(f"op path launched {want_zero}: {launches}")
    if launches["flash_e2softmax"] != len(FLASH_MODES) + 1:
        raise AssertionError(f"{launches['flash_e2softmax']} flash launches")
    for key, r in res["flash"].items():
        b, s, _, h, _, hd, _ = FLASH_CASES[r["name"]]
        want = r["out"].reshape(b, h, s, hd).transpose(1, 2).to(
            inp["flash"][r["name"]]["q"].dtype)
        if not torch.equal(outs[key], want):
            raise AssertionError(f"flash op {key}: output differs from the "
                                 "kernel's")
    for name, r in res["norms"].items():
        for tag, pre in (("", ""), ("b", "b")):
            h, out = outs[f"{tag}res_{name}"]
            hq, (codes, scale) = outs[f"{tag}resq_{name}"]
            want = (r[pre + "out_q"], r[pre + "h"], r[pre + "out"],
                    r["bh8" if tag else "h"], r[pre + "codes"],
                    r[pre + "scale"])
            if not all(torch.equal(a, b) for a, b in zip(
                    (outs[f"{tag}norm_{name}"], h, out, hq, codes, scale),
                    want)):
                raise AssertionError(f"static-params norm ops {name} "
                                     f"{'bf16' if tag else 'float32'} "
                                     "differ from the kernels'")
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
                  f"{'causal' if causal else 'non-causal'} {r['mode']} "
                  f"{str(args[0].dtype).replace('torch.', '')}",
            variant=r["variant"],
            ms=time_ms(torch, run, flush),
            kernel_ms=profiled_kernel_ms(torch, run, flush,
                                         "flash_e2softmax_"),
            plain_ms=time_ms(torch, lambda: KA.flash_e2softmax_plain(
                *args, **kkw), flush, reps=3),
            bound_ms=bms, bound_by=by, library_ms=lib,
            library="torch.nn.functional.scaled_dot_product_attention"
            if lib is not None else None,
            max_abs_err=r["max_abs_err"], bytes=nbytes, flops=flops)
    qn = dict(name="ailayernorm_qnorm", route="cuda",
              source="src/repro_torch/kernels/csrc/ailayernorm.cu",
              replaces="src/repro/kernels/ailayernorm.py:133", shapes={})
    add = dict(name="ailayernorm_add_norm", route="cuda",
               source="src/repro_torch/kernels/csrc/ailayernorm.cu",
               replaces="src/repro/kernels/ailayernorm.py:205", shapes={})
    addq = dict(name="ailayernorm_add_norm_quant", route="cuda",
                source="src/repro_torch/kernels/csrc/ailayernorm.cu",
                replaces="src/repro/kernels/ailayernorm.py:257", shapes={})
    for name, r in res["norms"].items():
        args, rms = r["args"], r["rms"]
        x, xr = args[0], args[1]
        rows, c = x.shape
        # the bytes' floor under the same flush, in the same call: torch
        # moving the rows alone (a yardstick, not the same function)
        dst = torch.empty_like(x)
        floors = {
            "out.copy_(x)": time_ms(torch, lambda: dst.copy_(x), flush),
            "torch.add(x, r, out=h)": time_ms(
                torch, lambda: torch.add(x, xr, out=dst), flush)}
        # alpha, gamma (and beta) and the scale, read once
        chan_bytes = c * (8 if rms else 12) + 4
        for e, fn, plain, fargs, row_bytes, extra_ops, kname, floor in (
                (qn, KN.qnorm, KN.qnorm_plain, (x,) + args[2:], 8, 0,
                 "qnorm_kernel", "out.copy_(x)"),
                (add, KN.add_norm, KN.add_norm_plain, args, 16, 4,
                 "add_norm_kernel", "torch.add(x, r, out=h)"),
                (addq, KN.add_norm_quant, KN.add_norm_quant_plain, args, 13,
                 4, "add_norm_quant", "torch.add(x, r, out=h)")):
            nbytes = rows * c * row_bytes + chan_bytes \
                + (4 * rows if e is addq else 0)
            bms, by = bound_ms(nbytes, (QNORM_OPS_PER_ELEMENT + extra_ops)
                               * rows * c, FP32_FLOPS)

            def run(fn=fn, fargs=fargs):
                return fn(*fargs, rms=rms)
            e["shapes"][name] = dict(
                shape=f"rows {rows} C {c} {'rms' if rms else 'ln'} float32",
                ms=time_ms(torch, run, flush),
                kernel_ms=profiled_kernel_ms(torch, run, flush, kname),
                plain_ms=time_ms(torch, lambda plain=plain, fargs=fargs:
                                 plain(*fargs, rms=rms), flush, reps=10),
                bound_ms=bms, bound_by=by, library_ms=None,
                max_abs_err=r["max_abs_err"], bytes=nbytes,
                floor=floor, floor_ms=floors[floor])
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
    for e, main in ((flash, "qwen2_causal_sole"), (qn, "rms_2048x896"),
                    (add, "rms_2048x896"), (addq, "rms_2048x896"),
                    (codes, "codes")):
        top = e["shapes"][main]
        e.update(launches=launches[e["name"]], max_abs_err=max(
            v["max_abs_err"] for v in e["shapes"].values()),
            ms=top["ms"], plain_ms=top["plain_ms"], bound_ms=top["bound_ms"],
            bound_by=top["bound_by"], library_ms=top["library_ms"],
            main_shape=main)
        table.append(e)
        for sname, v in e["shapes"].items():
            k, lib = v["kernel_ms"], v["library_ms"]
            floor = v.get("floor_ms")
            log(f"{e['name']} {sname} [{v['shape']}]: {v['ms'] * 1e3:.2f} us "
                f"(profiler: kernel "
                f"{'not measured' if k is None else f'{k * 1e3:.2f} us'}; "
                f"plain {v['plain_ms'] * 1e3:.1f} us, bound "
                f"{v['bound_ms'] * 1e3:.3f} us by {v['bound_by']}"
                + ("" if lib is None else f"; SDPA {lib * 1e3:.1f} us")
                + ("" if floor is None else f"; {v['floor']} alone "
                   f"{floor * 1e3:.2f} us") + ")")
    return table


# the static-params SOLE norm ops: (op, rows, C) of the bf16 op stage,
# at decode and prefill-chunk rows of qwen2_0_5b's RMS width and
# stablelm_1_6b's LayerNorm width
STATIC_STAGE = (("rmsnorm", 8, 896), ("rmsnorm", 128, 896),
                ("residual_rmsnorm", 8, 896), ("residual_rmsnorm", 128, 896),
                ("residual_layernorm", 8, 2048),
                ("residual_layernorm", 128, 2048))
STATIC_OPS = ("layernorm", "rmsnorm", "residual_layernorm",
              "residual_rmsnorm", "residual_layernorm_q", "residual_rmsnorm_q")


def is_static_norm(key: str) -> bool:
    """A profiler key of a static-params norm kernel (either body)."""
    return any(k in key for k in ("qnorm_kernel", "add_norm_kernel",
                                  "add_norm_quant", "norm_row_kernel"))


def static_op_stage(torch):
    """The static-params norm ops as op-layer users call them: every
    ``layernorm``/``rmsnorm``/``residual_*``/``residual_*_q`` ``sole`` op
    with ``params=`` on float32 and on bf16 rows (output in the rows'
    dtype) is one device kernel per call under the profiler and equal bit
    for bit to its plain version on the float32 view of the rows; then
    the bf16 stage (``STATIC_STAGE``, bf16 out) by CUDA events (L2
    flushed), host wall per call and the kernel alone (profiler); bound:
    the bf16 rows read and the output (and float32 h) written once.
    Params calibrated on a held-out bf16 batch (a bf16 scale)."""
    from repro_torch import ops
    from repro_torch.core.sole.quant import calibrate_ptf
    from repro_torch.kernels import ailayernorm as KN
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda").zero_
    gen = torch.Generator(device="cuda").manual_seed(18)
    wrappers = (KN.qnorm, KN.add_norm, KN.add_norm_quant)

    def case(op, rows, c, dtype):
        def acts():
            x = torch.randn((rows, c), generator=gen, device="cuda") * 2
            x[:, ::7] *= 8
            return x.to(dtype)
        rms = "rmsnorm" in op
        x, held_out = acts(), acts()
        r = torch.randn((rows, c), generator=gen, device="cuda").to(dtype)
        gamma = 1 + 0.1 * torch.randn((c,), generator=gen, device="cuda")
        beta = 0.1 * torch.randn((c,), generator=gen, device="cuda")
        p = calibrate_ptf(held_out, unsigned=not rms)
        fn = ops.resolve(op, "sole", "cuda")
        extra = () if rms else (beta,)
        head = (x,) if not op.startswith("residual_") else (x, r)
        kw = dict(params=p) if op.endswith("_q") else dict(params=p,
                                                           out_dtype=dtype)
        chan = (p.scale, p.alpha, gamma, None if rms else beta)
        xf, rf = x.float(), r.float()
        if op.endswith("_q"):
            h, codes, qs = KN.add_norm_quant_plain(xf, rf, *chan, rms=rms)
            want = (h, codes, qs)
        elif op.startswith("residual_"):
            h, out = KN.add_norm_plain(xf, rf, *chan, rms=rms)
            want = (h, out.to(dtype))
        else:
            want = (KN.qnorm_plain(xf, *chan, rms=rms).to(dtype),)
        return (lambda: fn(*head, gamma, *extra, **kw)), want

    def flat(out):
        if isinstance(out, torch.Tensor):
            return (out,)
        return tuple(t for o in out for t in flat(o))

    checked = {}
    for dtype in (torch.float32, torch.bfloat16):
        for op in STATIC_OPS:
            c = 896 if "rmsnorm" in op else 2048
            call, want = case(op, 8, c, dtype)
            got = flat(call())
            torch.cuda.synchronize()
            if not all(a.dtype == b.dtype and torch.equal(a, b)
                       for a, b in zip(got, want)):
                raise AssertionError(f"static-params op {op} {dtype}: "
                                     "differs from the plain version")
            n, other, seen = device_kernels(torch, call, wrappers=wrappers,
                                            ours=is_static_norm)
            if n != 1 or other:
                raise AssertionError(f"static-params op {op} {dtype}: {n} "
                                     f"device kernels per call, others "
                                     f"{other}")
            checked[f"{op}_{str(dtype)[6:]}"] = dict(device_kernels=n,
                                                      records_kept=seen)
    log("static-params norm ops (6 ops, float32 and bf16 rows, 8 rows): "
        "bitwise equal to the plain versions, 1 device kernel per call "
        "each (profiler records kept of 5: "
        + json.dumps({k: v["records_kept"] for k, v in checked.items()})
        + ")")
    stage = {}
    for op, rows, c in STATIC_STAGE:
        call, _ = case(op, rows, c, torch.bfloat16)
        kname = "add_norm_kernel" if op.startswith("residual_") \
            else "qnorm_kernel"
        nbytes = rows * c * (2 + 2 + (6 if op.startswith("residual_")
                                      else 0)) \
            + c * (8 if "rmsnorm" in op else 12) + 2
        bms, by = bound_ms(nbytes, QNORM_OPS_PER_ELEMENT * rows * c,
                           FP32_FLOPS)
        v = stage[f"{op}_{rows}x{c}"] = dict(
            shape=f"{op} rows {rows} C {c} bf16 in, bf16 out",
            ms=time_ms(torch, call, flush),
            kernel_ms=profiled_kernel_ms(torch, call, flush, kname),
            wall_ms=wall_ms(torch, call),
            kernels_per_call=device_kernels(torch, call, wrappers=wrappers,
                                            ours=is_static_norm)[0],
            bound_ms=bms, bound_by=by, bytes=nbytes)
        k = v["kernel_ms"]
        log(f"static op stage {op} {rows}x{c} bf16: {v['ms'] * 1e3:.2f} us "
            f"events (profiler: kernel "
            f"{'not measured' if k is None else f'{k * 1e3:.2f} us'}), host "
            f"wall {v['wall_ms'] * 1e3:.1f} us, {v['kernels_per_call']} "
            f"device kernel(s) per call; bound {v['bound_ms'] * 1e3:.3f} us "
            f"by {v['bound_by']}")
    return dict(checked=checked, stage=stage)


def is_dense_e2(key: str) -> bool:
    """A profiler key of the E2Softmax kernel (either body), not of the
    paged or dense flash kernels."""
    return ("e2softmax_" in key and "paged_e2softmax" not in key
            and "flash_e2softmax" not in key)


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
    # forwards: one attention launch per layer (the paged kernel, or the
    # dense engine's E2Softmax); kernels per forward: every device kernel
    kernels = sum(n for _, n, _ in rows)
    attn = sum(n for _, n, key in rows
               if (is_dense_e2(key) if dense else "paged_e2softmax" in key))
    forwards = attn / cfg.n_layers
    per_fwd = kernels / forwards if forwards else float("nan")
    log(f"[{label}] profiled wave: wall {wall:.3f} s, device busy "
        f"{busy:.3f} s ({busy / wall:.3f} of wall), "
        f"{len(reqs) * NEW_TOKENS} new tokens, {kernels} kernels over "
        f"{forwards:.0f} forwards ({per_fwd:.1f} per forward)")
    for us, n, key in rows[:12]:
        log(f"  {us / 1e3:9.2f} ms {n:7d} x  {key[:100]}")
    return {"wall_s": wall, "device_busy_s": busy, "kernels": kernels,
            "forwards": forwards, "kernels_per_forward": per_fwd,
            "top": [{"ms": us / 1e3, "count": n, "kernel": key[:100]}
                    for us, n, key in rows[:12]]}


# -- the relu2 + LayerNorm configs (minitron_8b, nemotron_4_15b) -------------


def check_paged_d128(torch, cfg):
    """Phase 3 at minitron_8b's attention (head dim 128, 32 heads over 8
    KV heads): the paged kernel (the CUDA-core route: ``d^-1/2 =
    2^-3.5`` is no power of two) against its plain version at the decode
    and prefill-chunk shapes, over bf16 pools and int8 pools (``quant_pv``
    on and off). The scaled q (plain) and the scaled logits (kernel)
    round apart, so exact mode is held to 1e-4 of the output scale and a
    SOLE output, whose codes can flip at a tie, to at most 1% of rows off
    by more than 1e-3. Returns (bf16 results, int8 results) keyed
    ``minitron_decode``/``minitron_prefill``."""
    from repro_torch.kernels import flash_e2softmax as KA
    from repro_torch.models.layers import KV_INT8_SCALE, LOGIT_INT8_SCALE
    gen = torch.Generator(device="cuda").manual_seed(5)
    h, kvh, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kvmap = KA.default_kv_head_map(h, kvh, "cuda")
    shapes = {
        "prefill": dict(b=1, c=PREFILL_CHUNK, q_start=[PREFILL_CHUNK],
                        kv_lens=[2 * PREFILL_CHUNK]),
        "decode": dict(b=DECODE_BATCH, c=1, q_start=[0] * DECODE_BATCH,
                       kv_lens=[49, 300, 117, 1, 256, 83, 160, 1]),
    }
    out16, out8 = {}, {}
    for name, sh in shapes.items():
        causal = name == "prefill"
        for int8, store in ((False, out16), (True, out8)):
            case = paged_case(torch, gen, h=h, kvh=kvh, d=d, grid=False,
                              int8=int8, **sh)
            variant = KA.paged_variant(case[0].dtype, case[1].dtype, d,
                                       case[1].shape[1], KV_INT8_SCALE)
            if variant != "CUDA cores":
                raise AssertionError(f"paged d={d}: {variant}")
            errs, offs = {}, {}
            for mode in ("sole", "exact"):
                for quant_pv in ((True, False) if int8 else (False,)):
                    kw = dict(sole=mode == "sole", exp_bits=cfg.exp_bits,
                              int8_scale=(LOGIT_INT8_SCALE if mode == "sole"
                                          else None))
                    if int8:
                        kw.update(kv_scale=KV_INT8_SCALE, quant_pv=quant_pv)
                    out = KA.flash_e2softmax_paged(*case, causal=causal,
                                                   **kw)
                    ref = KA.flash_e2softmax_paged_plain(
                        *case, kvmap, causal=causal, **kw)
                    torch.cuda.synchronize()
                    if not torch.isfinite(out).all():
                        raise AssertionError(f"paged d={d} {name}: "
                                             "non-finite")
                    err = (out - ref).abs()
                    scale = max(ref.abs().max().item(), 1.0)
                    key = f"{mode}{'_pv' if quant_pv else ''}"
                    errs[key] = err.max().item()
                    if mode == "exact":
                        if errs[key] > 1e-4 * scale:
                            raise AssertionError(
                                f"paged d={d} {name} int8={int8} {key}: max "
                                f"|err| {errs[key]} > {1e-4 * scale}")
                        continue
                    offs[key] = (err.amax(-1) > 1e-3 * scale).float().mean(
                        ).item()
                    if offs[key] > 0.01:
                        raise AssertionError(
                            f"paged d={d} {name} int8={int8} {key}: "
                            f"{offs[key]} of rows off by > 1e-3")
            store[f"minitron_{name}"] = dict(
                case=case, causal=causal, errs=errs, rows_off=offs,
                max_abs_err=max(errs.values()),
                max_abs_err_random=max(errs.values()))
            log(f"paged_e2softmax d={d} H {h}/KV {kvh} {name} "
                f"{'int8' if int8 else 'bf16'} pools [{variant}]: max|err| "
                + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
                + "; SOLE rows off by > 1e-3: "
                + ", ".join(f"{k} {v:.5f}" for k, v in offs.items()))
    return out16, out8


def check_new_e2_stage(torch, cfg, e2):
    """Phase 3: the dense path's ``_sole_probs`` stage at ``cfg``'s
    attention (32 heads in groups of 4), bitwise equal to the chain, one
    launch per call; merged into ``e2`` for the timing."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    stage = dense_stage_inputs(torch, cfg, gen)
    checked = check_sole_probs(torch, cfg, stage)
    for k in stage:
        e2["stage"][f"minitron_{k}"] = checked[k]
        e2["stage_inputs"][f"minitron_{k}"] = stage[k]


class SampleRecorder:
    """Wraps the paged horizon's ``sample_tokens`` and keeps its stochastic
    calls' logits (on the host), stream parameters and tokens until they
    hold ``keep`` live-lane draws, so the host ``Sampler`` can redraw
    them."""

    def __init__(self, keep=24):
        from repro_torch.models import transformer as T
        self.module, self.orig = T, T.sample_tokens
        self.keep, self.calls, self.draws = keep, [], 0

    def __enter__(self):
        def wrapped(logits, temperature, top_k, seed, counter, vocab_size,
                    **kw):
            toks = self.orig(logits, temperature, top_k, seed, counter,
                             vocab_size, **kw)
            if kw.get("stochastic") and self.draws < self.keep:
                self.calls.append(tuple(
                    t.cpu().numpy() for t in (logits, temperature, top_k,
                                              seed, counter, toks)))
                self.draws += int((temperature > 0).sum())
            return toks
        self.module.sample_tokens = wrapped
        return self

    def __exit__(self, *exc):
        self.module.sample_tokens = self.orig


def stochastic_replay(torch, cfg, params):
    """Phase 4: one stochastic trace (temperature 0.8, top-k 40, a seed per
    request) through ``PagedEngine`` three times: cold, again on the warm
    prefix cache, and cold in a pool of ``PREEMPT_BLOCKS`` pages that
    forces recompute-preemption. In exact mode: a SOLE norm calibrates
    over the whole batch, so its tokens depend on which lanes and chunks
    share a step, which the three runs change by design.

    The warm run must give the cold run's tokens, and the device
    sampler's tokens must equal the host ``Sampler``'s for the same
    (seed, counter) on the logits that produced them. A preempted
    sequence recomputes its kept tokens' K/V through prefill chunks,
    whose GEMMs (128 rows) round apart from the decode steps' (8 rows):
    the preempted run must give the cold run's tokens for every request
    up to the first token drawn after such a recompute; where it
    diverges later is reported."""
    from repro_torch.serve.engine import PagedEngine, Request
    from repro_torch.serve.sampling import Sampler
    cfg = dataclasses.replace(cfg, softmax_mode="exact", norm_mode="exact",
                              logit_int8=False)
    prompts, _ = trace_prompts(cfg)
    reqs = [Request(prompt=p, max_new_tokens=NEW_TOKENS, seed=1000 + i,
                    **STOCHASTIC) for i, p in enumerate(prompts)]

    def engine(blocks):
        return PagedEngine(cfg, params, num_blocks=blocks,
                           block_size=BLOCK_SIZE, max_seq_len=MAX_SEQ_LEN,
                           max_running=8, decode_batch=DECODE_BATCH,
                           prefill_chunk=PREFILL_CHUNK, decode_horizon=8,
                           device="cuda")
    eng = engine(8 * MAX_SEQ_LEN // BLOCK_SIZE + 1)
    runs, walls = {}, {}
    with SampleRecorder() as rec:
        t0 = time.time()
        runs["cold"] = eng.generate(reqs)
        walls["cold"] = time.time() - t0
    t0 = time.time()
    runs["warm"] = eng.generate(reqs)
    walls["warm"] = time.time() - t0
    warm_hits = eng.stats()["prefix_hit_tokens"]
    tight = engine(PREEMPT_BLOCKS)
    # tokens each request had kept at each preemption: its replay
    # recomputes the K/V of out[:-1], which decode steps wrote, once that
    # count is 2 or more
    kept_at_preempt = {}
    preempt = tight.sched.preempt

    def recording_preempt(seq):
        kept_at_preempt.setdefault(seq.seq_id, []).append(len(seq.out))
        return preempt(seq)
    tight.sched.preempt = recording_preempt
    t0 = time.time()
    runs["preempted"] = tight.generate(reqs)
    walls["preempted"] = time.time() - t0
    pre = tight.stats()["preemptions"]
    for e in (eng, tight):
        e.cache.check_refcounts()
    if warm_hits <= 0 or pre <= 0:
        raise AssertionError(f"warm prefix hits {warm_hits}, preemptions "
                             f"{pre}: the replays did not exercise them")
    if runs["cold"] != runs["warm"]:
        raise AssertionError("stochastic warm replay differs from cold")
    if any(len(o) != NEW_TOKENS for r in runs.values() for o in r):
        raise AssertionError("stochastic trace: token counts")
    if len({t for o in runs["cold"] for t in o}) < NEW_TOKENS:
        raise AssertionError("stochastic trace: too few distinct tokens")
    diverged = {}
    for i, (a, b) in enumerate(zip(runs["cold"], runs["preempted"])):
        first = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                     None)
        if first is None:
            continue
        # seq ids follow submission order on a fresh engine
        recomputed = [n for n in kept_at_preempt.get(i, []) if n >= 2]
        if first < min(recomputed, default=NEW_TOKENS):
            raise AssertionError(
                f"preempted replay of request {i} differs at token {first},"
                f" before any recomputed decode K/V (tokens kept at its "
                f"preemptions: {kept_at_preempt.get(i)})")
        diverged[i] = first
    checked = 0
    for logits, temp, top_k, seed, ctr, toks in rec.calls:
        for i in range(len(toks)):
            if temp[i] <= 0:
                continue                     # a null lane
            host = Sampler(temperature=float(temp[i]), top_k=int(top_k[i]),
                           seed=int(seed[i]), vocab_size=cfg.vocab_size)
            want = host.draw(logits[i], int(ctr[i]))
            if want != int(toks[i]):
                raise AssertionError(
                    f"device draw {int(toks[i])} != host Sampler {want} at "
                    f"seed {int(seed[i])} counter {int(ctr[i])}")
            checked += 1
    if not checked:
        raise AssertionError("no stochastic device draw was recorded")
    log(f"[{cfg.name} stochastic, exact mode] cold {walls['cold']:.3f} s, "
        f"warm {walls['warm']:.3f} s ({warm_hits} prefix-hit tokens): "
        f"identical tokens; preempted {walls['preempted']:.3f} s ({pre} "
        f"preemptions in {PREEMPT_BLOCKS} pages; tokens kept at each "
        f"request's preemptions {kept_at_preempt}): identical up to "
        f"every recompute of decode K/V, diverging after it in requests "
        f"(request: first differing token) {diverged}; {checked} device "
        f"draws equal to the host Sampler's; request 0: {runs['cold'][0]}")
    return {"walls_s": walls, "prefix_hit_tokens": warm_hits,
            "preemptions": pre, "kept_at_preemption": kept_at_preempt,
            "diverged_after_recompute": diverged,
            "host_checked_draws": checked}


def blocked_prefill(torch, cfg, params):
    """Phase 4: one ``BLOCKED_PROMPT``-token prompt through ``api.prefill``
    at full width, which takes the blocked (online-normalized) attention,
    against ``attn_impl="dense"`` on the same inputs, in exact mode:
    prints the largest logit difference and whether the argmax agrees;
    then once in SOLE mode (finite logits)."""
    import numpy as np
    from repro_torch.models import api
    from repro_torch.models import layers as L
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (1, BLOCKED_PROMPT)).astype(np.int32)).cuda()
    exact = dataclasses.replace(cfg, softmax_mode="exact",
                                norm_mode="exact", logit_int8=False)
    calls = {"blocked": 0}
    orig = L.attend_blocked

    def counted(*a, **k):
        calls["blocked"] += 1
        return orig(*a, **k)
    out = {}
    L.attend_blocked = counted
    try:
        for label, c in (("blocked", exact),
                         ("dense", dataclasses.replace(exact,
                                                       attn_impl="dense")),
                         ("blocked_sole", cfg)):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.time()
            logits, _ = api.prefill(params, tokens, c, BLOCKED_PROMPT)
            torch.cuda.synchronize()
            out[label] = dict(logits=logits[0, -1].float(),
                              wall_s=time.time() - t0,
                              peak_gib=torch.cuda.max_memory_allocated()
                              / 2 ** 30)
    finally:
        L.attend_blocked = orig
    if calls["blocked"] != 2 * cfg.n_layers:
        raise AssertionError(f"{calls['blocked']} blocked attention calls, "
                             f"not {2 * cfg.n_layers}")
    b, d = out["blocked"]["logits"], out["dense"]["logits"]
    for k, v in out.items():
        if not torch.isfinite(v["logits"]).all():
            raise AssertionError(f"blocked prefill {k}: non-finite logits")
    diff = (b - d).abs().max().item()
    rng = (d.max() - d.min()).item()
    agree = int(b.argmax()) == int(d.argmax())
    # bf16 activations: the two attentions round their outputs apart and
    # 32 layers carry it; a wrong blocked path moves logits by their range
    if diff > 0.1 * rng:
        raise AssertionError(f"blocked vs dense prefill: max |diff| {diff} "
                             f"> 0.1 of the logit range {rng}")
    log(f"[{cfg.name} blocked prefill] {BLOCKED_PROMPT} tokens, exact mode: "
        f"blocked {out['blocked']['wall_s']:.3f} s (peak "
        f"{out['blocked']['peak_gib']:.2f} GiB), dense "
        f"{out['dense']['wall_s']:.3f} s (peak "
        f"{out['dense']['peak_gib']:.2f} GiB); last-position logits max "
        f"|blocked - dense| {diff:.4e} (logit range {rng:.3f}), argmax "
        f"agrees: {agree}; SOLE blocked {out['blocked_sole']['wall_s']:.3f} "
        "s, finite")
    return {"max_abs_diff": diff, "logit_range": rng, "argmax_agrees": agree,
            **{f"{k}_wall_s": v["wall_s"] for k, v in out.items()},
            **{f"{k}_peak_gib": v["peak_gib"] for k, v in out.items()}}


def serve_new_configs(torch):
    """Phase 4 for the relu2 + LayerNorm configs at full width (32 layers,
    random weights from a seed): minitron_8b through ``PagedEngine`` in
    bf16, through the dense-slot ``Engine`` in bf16, the stochastic
    replays and the blocked prefill on the same weights, the profiled
    paged wave; then at w8a8 with int8 KV pages; then nemotron_4_15b
    through ``PagedEngine`` in bf16 (at w8a8 its float32 masters, 62 GB,
    and codes, 15.6 GB, would not fit in 80 GB beside the run). Each
    model is freed before the next. Returns the launches and traces."""
    from repro_torch.configs.base import QuantConfig, get_config
    mini = get_config("minitron_8b")
    out = {}
    launches, trace, params = serve_full_width(torch, mini, "minitron bf16")
    out["minitron_bf16"] = (launches, trace)
    out["minitron_dense_bf16"] = serve_dense_full_width(
        torch, mini, params, "minitron dense bf16")
    trace["stochastic"] = stochastic_replay(torch, mini, params)
    trace["blocked_prefill"] = blocked_prefill(torch, mini, params)
    trace["profile"] = profile_engine(torch, mini, params, "minitron bf16")
    del params
    torch.cuda.empty_cache()
    mini8 = dataclasses.replace(mini, quant=QuantConfig("w8a8"),
                                kv_cache_dtype="int8")
    launches8, trace8, params8 = serve_full_width(torch, mini8,
                                                  "minitron w8a8")
    out["minitron_w8a8"] = (launches8, trace8)
    del params8
    torch.cuda.empty_cache()
    nemo = get_config("nemotron_4_15b")
    launches_n, trace_n, params_n = serve_full_width(torch, nemo,
                                                     "nemotron bf16")
    out["nemotron_bf16"] = (launches_n, trace_n)
    del params_n
    torch.cuda.empty_cache()
    return out


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
        sass = sass_mma_counts(build)
        if sass is None:
            log("[sass] cuobjdump not found: tensor-core instructions not "
                "counted")
        else:
            for fn, ops in sass.items():
                log(f"[sass] {fn}: {json.dumps(ops)}")
            for fn, ops in sass.items():
                if "mma_kernel" in fn and not any("BF16" in o for o in ops):
                    raise AssertionError(f"{fn} issues no bf16 HMMA")
        cfg = get_config("qwen2_0_5b")
        cfg8 = dataclasses.replace(cfg, quant=QuantConfig("w8a8"),
                                   kv_cache_dtype="int8")
        attn = check_kernels(torch, cfg)
        calib = check_calib_norm(torch)
        attn8 = check_int8_paged(torch, cfg)
        mini = get_config("minitron_8b")
        attn16_d128, attn8_d128 = check_paged_d128(torch, mini)
        attn.update(attn16_d128)
        attn8.update(attn8_d128)
        gemm = check_int8_gemm(torch)
        e2 = check_e2softmax(torch, cfg)
        check_new_e2_stage(torch, mini, e2)
        ops_inp = ops_inputs(torch)
        ops_res = check_ops_kernels(torch, ops_inp)
        launches, trace, params = serve_full_width(torch, cfg, "bf16")
        launches8, trace8, params8 = serve_full_width(torch, cfg8, "w8a8")
        dlaunches, dtrace = serve_dense_full_width(torch, cfg, params,
                                                   "dense bf16")
        dlaunches8, dtrace8 = serve_dense_full_width(torch, cfg8, params8,
                                                     "dense w8a8")
        olaunches = serve_ops_path(torch, ops_inp, ops_res)
        new = serve_new_configs(torch)
        small_engine_parity(torch)
        table = time_kernels(torch, attn, launches, cfg)
        table.append(time_calib_norm(torch, calib, launches))
        table += time_w8a8_kernels(torch, attn8, gemm, launches8, cfg)
        table += time_e2softmax(torch, e2, dlaunches, dlaunches8)
        table += time_ops_kernels(torch, ops_res, olaunches)
        static = static_op_stage(torch)
        for e in table:
            if e["name"] == "ailayernorm_qnorm":
                e["launches_paged"] = launches[e["name"]]
            if e["name"] in ("ailayernorm_qnorm", "ailayernorm_calib"):
                e["launches_w8a8"] = launches8[e["name"]]
                e["launches_dense"] = dlaunches[e["name"]]
                e["launches_ops"] = olaunches[e["name"]]
            if e["name"] in ("ailayernorm_qnorm", "ailayernorm_add_norm"):
                e["op_stage"] = {k: v for k, v in static["stage"].items()
                                 if k.startswith("residual_")
                                 == (e["name"] == "ailayernorm_add_norm")}
            if e["name"] == "e2softmax":
                e["launches_ops"] = olaunches["e2softmax"]
            if e["name"] == "int8_matmul":
                e["launches_dense_w8a8"] = dlaunches8["int8_matmul"]
            key = ("paged_e2softmax" if e["name"] == "paged_e2softmax_int8kv"
                   else e["name"])
            e["launches_new_paths"] = {
                path: res[0][key] for path, res in new.items()
                if key in res[0]}
        trace["profile"] = profile_engine(torch, cfg, params, "bf16")
        dtrace["profile"] = profile_engine(torch, cfg, params, "dense bf16",
                                           dense=True)
        del params
        trace8["profile"] = profile_engine(torch, cfg8, params8, "w8a8")
        dtrace8["profile"] = profile_engine(torch, cfg8, params8,
                                            "dense w8a8", dense=True)
        log(json.dumps({"trace": trace, "trace_w8a8": trace8,
                        "trace_dense": dtrace, "trace_dense_w8a8": dtrace8,
                        "static_ops": static["checked"],
                        **{f"trace_{k}": v[1] for k, v in new.items()}}))
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
