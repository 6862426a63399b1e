#!/usr/bin/env python3
"""Time the port's kernels from two checkouts on one NVIDIA GPU, in turns
(base, this, this, base), so two versions are compared inside one run on
one card. Run from the root of a checkout, with another checkout of the
repository at ``BASE``::

    python3 kernel_ab.py --base BASE [--only paged,sweep,norm,flash,gemm,e2,qnorm,exact,calib,wave,moe]

Each turn is a fresh process that puts ``<checkout>/src`` first on the
path, builds that checkout's kernels there (``kernels/build.py``) and
times, with CUDA events and the L2 cache flushed before each launch:

* ``paged``: the paged Flash-E2Softmax at qwen2_0_5b's serve shapes (a
  decode step of 8 sequences over 1-300 keys, a causal 128-token prefill
  chunk over 256 keys), SOLE with the int8 snap, over bf16 pools and over
  int8 pools (``quant_pv``), as ``chip_smoke.py`` builds them; the same
  at head dim 128 (minitron_8b: 32 heads on 8 KV heads; bf16 and int8
  pools) with its verify dispatch's 40 rows as decode rows (8 lanes x C
  5, ``chip_smoke.decode_rows_case``), and at head dim 256
  (recurrentgemma_9b: 16 heads on 1 KV head; bf16 pools); each d-128/256
  bf16 shape also beside ``scaled_dot_product_attention`` on the K/V
  gathered beforehand (``chip_smoke.paged_exact_vs_sdpa``);
* ``sweep``: the paged decode step of 8 sequences at one kv length each,
  from 16 to 2,048 keys (one to sixteen 128-key chunks);
* ``norm``: the SOLE norm stage of a model's ``apply_residual_norm``, the
  op ``residual_rmsnorm`` (``repro_torch.ops.resolve(..., "cuda")``, which
  both checkouts have) on bf16 x and r at 8 and 128 rows of 896, with its
  output cast to bf16: device time by CUDA events and host wall time per
  call (the path is host-bound, so the wall is what it pays);
* ``flash``: the dense flash kernel on bf16 inputs at the op layer's
  shapes (qwen2_0_5b's 2048-token causal attention in four modes, a ragged
  non-causal case, stablelm_1_6b's MHA), beside
  ``scaled_dot_product_attention`` (exact mode);
* ``gemm``: the int8 GEMM at every (M, K, N) of the w8a8 path (M = 8 and
  128), beside ``torch._int_mm`` (at M = 8 on the activation zero-padded
  to 24 rows: it refuses M <= 16);
* ``e2``: the E2Softmax kernel alone at the dense path's decode (112 x
  385) and prefill (33,600 x 300) rows, on snapped float32 logits with a
  contiguous mask and float32 out (both checkouts' wrappers take these),
  and the path's whole SOLE-probability stage ``layers._sole_probs`` on
  raw logits with the path's mask, bf16 out (for a checkout whose
  ``_sole_probs`` returns float32, followed by the cast the path made),
  each by CUDA events and by host wall per call;
* ``qnorm``: the three static-PTF kernels (``add_norm_quant``, ``qnorm``,
  ``add_norm``) on float32 rows at ``chip_smoke.NORM_CASES`` (8, 128 and
  2048 rows of 896, RMS; 128 and 2048 rows of 2048, LayerNorm), each
  checkout's wrappers given the channel arguments they take (the
  per-channel divisor ``denom``, or the PTF scale), and the bf16
  static-params op calls of ``chip_smoke.STATIC_STAGE`` (``rmsnorm``,
  ``residual_rmsnorm``, ``residual_layernorm`` with ``params=`` and
  ``out_dtype=torch.bfloat16`` at 8 and 128 rows) by CUDA events and by
  host wall per call, whatever each checkout launches for them;
* ``exact``: the exact norm's forward (``exact_norm``: bf16 rows,
  float32 out) at ``chip_smoke.EXACT_NORM_CASES`` x 8, 40 and 2,400 rows,
  at the train step's RMS 896 x 8,192 bf16 rows with bf16 out, and on
  rwkv6's (64, 64) GroupNorm rows (float32, 512 / 8,192 / 153,600 rows),
  and its backward (``exact_norm_backward``, both of its launches) at
  every ``chip_smoke.NORM_BWD_CASES`` shape on float32 and bf16 rows
  (both checkouts' functions take the same arguments);
* ``calib``: the calibrating norm (``calibrated_norm``, one launch of
  ``calib_norm_kernel``) as a model's SOLE norms call it: the op
  ``residual_rmsnorm`` / ``residual_layernorm`` on bf16 x and r with bf16
  out (as ``chip_smoke.time_calib_norm`` calls it) at every
  ``chip_smoke.CALIB_CASES`` shape and ``chip_smoke.FAMILY_NORM_CASES``
  shape (whisper's LN 768 x 8 / 128 / 1,500, qwen2-vl's RMS 3,584 x 8 /
  2,048), one-row calls (RMS 896 and LN 4,096 x 1: one CTA), and rwkv6's
  GroupNorm rows (float32, a (64, 64) affine, no residual, float32 out)
  at 64 rows (one group) and every ``chip_smoke.GROUPNORM_CASES`` row
  count; by CUDA events into ``calib`` and the profiler's
  ``calib_norm_kernel`` time into ``calib_kernel`` (the wrapper's
  signature is the same in both checkouts);
* ``wave``: the host wall of one decode-heavy wave of ``PagedEngine`` and
  of the dense-slot ``Engine`` at qwen2_0_5b's full width, in bf16 and at
  w8a8 with int8 pages or cache (the end-to-end effect of the kernels and
  the host work around them), and of ``PagedEngine`` at minitron_8b's in
  bf16; and, from the same wave under the profiler, the device kernels
  per forward, the device busy seconds, the calibrating norm's share of
  them, and its launches and device microseconds a launch by route (its
  kernel's instantiations: ``<T, V, true>`` the grid, ``<T, V, false>``
  the cluster; one name in a checkout without routes);
* ``moe``: mixtral_8x7b at full width and ``chip_smoke.MIXTRAL_LAYERS``
  layers (bf16, SOLE), one profiled paged wave (``chip_smoke.profile_moe``):
  its wall, device busy, the expert FFN's device time and share of busy.

Inputs come from fixed seeds, alike in every turn. Prints one line per
shape (the mean of each checkout's two turns, and their ratios), the
``nvidia-smi`` line and one JSON object with every turn's times.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
# (case, mode) of the timed flash calls: chip_smoke's qwen2 case in every
# mode, the ragged and stablelm cases in SOLE mode; block 128
FLASH = (("qwen2_causal", "sole"), ("qwen2_causal", "sole_int8"),
         ("qwen2_causal", "sole_exact_corr"), ("qwen2_causal", "exact"),
         ("ragged_noncausal", "sole"), ("stablelm_mha", "sole"))


KINDS = ("paged", "sweep", "norm", "flash", "gemm", "e2", "qnorm", "exact",
         "calib", "wave", "moe")
# the paged kind's wide-head shapes: (label, heads, KV heads, head dim,
# pools); decode over chip_smoke's 1-300 keys, prefill a 128-row chunk
WIDE_PAGED = (("minitron", 32, 8, 128, ("bf16", "int8")),
              ("recurrentgemma", 16, 1, 256, ("bf16",)))
# the calib kind's one-row calls (rows, C, rms), beside chip_smoke's cases
CALIB_ONE_ROW = {"rms896_rows1": (1, 896, True), "ln4096_rows1": (1, 4096, False)}
# kv lengths of the decode sweep: one to sixteen 128-key chunks
SWEEP_KV = (16, 128, 300, 1024, 2048)


def worker(src: str, kinds) -> dict:
    """One turn: the kernels of the checkout whose package is under
    ``src``, timed at every shape of the kinds asked for."""
    sys.path.insert(0, src)
    import torch
    import torch.nn.functional as F
    from chip_smoke import (DECODE_BATCH, FLASH_CASES, GEMM_KN, INT_MM_MIN_M,
                            PREFILL_CHUNK, paged_case, time_ms, wall_ms)
    from repro_torch import ops
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_e2softmax as KA
    from repro_torch.kernels import int8_matmul as KM
    from repro_torch.models.layers import KV_INT8_SCALE, LOGIT_INT8_SCALE
    if not KA.__file__.startswith(src):
        raise RuntimeError(f"imported {KA.__file__}, not from {src}")
    torch.backends.cuda.matmul.allow_tf32 = False
    names = {"paged": "paged_e2softmax", "sweep": "paged_e2softmax",
             "norm": "ailayernorm", "flash": "flash_e2softmax",
             "gemm": "int8_matmul", "e2": "e2softmax",
             "qnorm": "ailayernorm", "exact": "ailayernorm",
             "calib": "ailayernorm"}
    # a wave runs every kernel of the serve paths
    build.build_all(None if {"wave", "moe"} & set(kinds)
                    else [names[k] for k in kinds])
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda").zero_
    gen = torch.Generator(device="cuda").manual_seed(15)
    out = {"paged": {}, "sweep": {}, "norm": {}, "norm_wall": {}, "flash": {},
           "gemm": {}, "sdpa": {}, "int_mm": {}, "e2": {}, "e2_wall": {},
           "qnorm": {}, "static_ops": {}, "static_ops_wall": {},
           "exact_fwd": {}, "exact_bwd": {}, "calib": {}, "calib_kernel": {},
           "wave": {}, "moe": {}}
    cfg = get_config("qwen2_0_5b")
    if "paged" in kinds:
        shapes = {"decode": dict(b=DECODE_BATCH, c=1,
                                 q_start=[0] * DECODE_BATCH,
                                 kv_lens=[49, 300, 117, 1, 256, 83, 160, 1]),
                  "prefill": dict(b=1, c=PREFILL_CHUNK,
                                  q_start=[PREFILL_CHUNK],
                                  kv_lens=[2 * PREFILL_CHUNK])}
        for pool in ("bf16", "int8"):
            for name, sh in shapes.items():
                case = paged_case(torch, gen, h=cfg.n_heads,
                                  kvh=cfg.n_kv_heads, d=cfg.head_dim,
                                  grid=True, int8=pool == "int8", **sh)
                kw = dict(causal=sh["c"] > 1, sole=True, exp_bits=4,
                          int8_scale=LOGIT_INT8_SCALE)
                if pool == "int8":
                    kw.update(kv_scale=KV_INT8_SCALE, quant_pv=True)
                out["paged"][f"{name}_{pool}"] = time_ms(
                    torch, lambda: KA.flash_e2softmax_paged(*case, **kw),
                    flush)
        wide_paged(torch, gen, flush, shapes, out)
    if "sweep" in kinds:
        import chip_smoke
        seq_len = chip_smoke.MAX_SEQ_LEN
        for kv in SWEEP_KV:
            chip_smoke.MAX_SEQ_LEN = max(SWEEP_KV)    # pages per sequence
            try:
                case = paged_case(torch, gen, b=DECODE_BATCH, c=1,
                                  q_start=[0] * DECODE_BATCH,
                                  kv_lens=[kv] * DECODE_BATCH,
                                  h=cfg.n_heads, kvh=cfg.n_kv_heads,
                                  d=cfg.head_dim, grid=True)
            finally:
                chip_smoke.MAX_SEQ_LEN = seq_len
            out["sweep"][f"kv{kv}"] = time_ms(
                torch, lambda: KA.flash_e2softmax_paged(
                    *case, causal=False, sole=True, exp_bits=4,
                    int8_scale=LOGIT_INT8_SCALE), flush)
    if "norm" in kinds:
        stage = ops.resolve("residual_rmsnorm", "sole", "cuda")
        for rows in (DECODE_BATCH, PREFILL_CHUNK):
            x = (torch.randn((rows, cfg.d_model), generator=gen,
                             device="cuda") * 3).to(torch.bfloat16)
            r = torch.randn((rows, cfg.d_model), generator=gen,
                            device="cuda").to(torch.bfloat16)
            gamma = 1 + 0.1 * torch.randn((cfg.d_model,), generator=gen,
                                          device="cuda")

            def run():                  # apply_residual_norm's calls
                h, o = stage(x, r, gamma, out_dtype=torch.bfloat16)
                return h.to(torch.bfloat16), o.to(torch.bfloat16)
            name = f"rows{rows}"
            out["norm"][name] = time_ms(torch, run, flush)
            out["norm_wall"][name] = wall_ms(torch, run, reps=300)
    if "e2" in kinds:
        e2_stage(torch, cfg, gen, flush, out)
    if "qnorm" in kinds:
        static_norms(torch, gen, flush, out)
    if "exact" in kinds:
        exact_norms(torch, gen, flush, out)
    if "calib" in kinds:
        calib_norms(torch, flush, out)
    if "wave" in kinds:
        out["wave"] = waves(torch, cfg)
    if "moe" in kinds:
        out["moe"] = moe_wave(torch)
    for case, mode in FLASH if "flash" in kinds else ():
        name = f"{case}_{mode}"
        b, s, t, h, kvh, hd, causal = FLASH_CASES[case]
        q = (torch.randint(-8, 9, (b * h, s, hd), generator=gen,
                           device="cuda") / 4).to(torch.bfloat16)
        kv = [torch.randint(-8, 9, (b * kvh, t, hd), generator=gen,
                            device="cuda").to(torch.bfloat16),
              torch.randn((b * kvh, t, hd), generator=gen,
                          device="cuda").to(torch.bfloat16)]
        k, v = (x.repeat_interleave(h // kvh, 0).contiguous() for x in kv)
        kw = dict(causal=causal, sole=mode != "exact", exp_bits=4,
                  int8_scale=LOGIT_INT8_SCALE if mode == "sole_int8"
                  else None, exact_corr=mode == "sole_exact_corr",
                  block_q=128, block_k=128)
        out["flash"][name] = time_ms(
            torch, lambda: KA.flash_e2softmax(q, k, v, **kw), flush)
        if mode == "exact":
            q4, k4, v4 = (x.reshape(b, h, -1, hd) for x in (q, k, v))
            out["sdpa"][name] = time_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    q4, k4, v4, is_causal=causal), flush)
    for m in (8, 128) if "gemm" in kinds else ():
        for nm, k, n in GEMM_KN:
            x = torch.randint(-127, 128, (m, k), generator=gen, device="cuda",
                              dtype=torch.int8)
            w = torch.randint(-127, 128, (k, n), generator=gen, device="cuda",
                              dtype=torch.int8)
            name = f"{nm}_m{m}"
            out["gemm"][name] = time_ms(torch, lambda: KM.int8_matmul(x, w),
                                        flush)
            xp = x
            if m < INT_MM_MIN_M:
                xp = torch.zeros((INT_MM_MIN_M, k), dtype=torch.int8,
                                 device="cuda")
                xp[:m] = x
            out["int_mm"][name] = time_ms(
                torch, lambda: torch._int_mm(xp, w), flush)
    return out


def wide_paged(torch, gen, flush, shapes, out) -> None:
    """The ``paged`` kind's head dims 128 and 256 (``WIDE_PAGED``) at
    ``shapes`` and, at 128, the verify rows as decode rows, into
    ``out["paged"]``; SDPA on the bf16 cases into ``out["sdpa"]``."""
    from chip_smoke import (DECODE_BATCH, VERIFY_K, decode_rows_case,
                            paged_case, paged_exact_vs_sdpa, time_ms,
                            verify_lanes)
    from repro_torch.kernels import flash_e2softmax as KA
    from repro_torch.models.layers import KV_INT8_SCALE, LOGIT_INT8_SCALE
    for label, h, kvh, d, pools in WIDE_PAGED:
        kvmap = KA.default_kv_head_map(h, kvh, "cuda")
        cases = dict(shapes)
        if d == 128:
            q_start, kv = verify_lanes(VERIFY_K + 1)
            cases["verify_rows"] = dict(b=DECODE_BATCH, c=VERIFY_K + 1,
                                        q_start=q_start, kv_lens=kv)
        for pool in pools:
            for name, sh in cases.items():
                case = paged_case(torch, gen, h=h, kvh=kvh, d=d, grid=True,
                                  int8=pool == "int8", **sh)
                causal = sh["c"] > 1 and name != "verify_rows"
                if name == "verify_rows":
                    case = decode_rows_case(torch, case)
                kw = dict(causal=causal, sole=True, exp_bits=4,
                          int8_scale=LOGIT_INT8_SCALE)
                if pool == "int8":
                    kw.update(kv_scale=KV_INT8_SCALE, quant_pv=True)
                key = f"{label}_{name}_{pool}"
                out["paged"][key] = time_ms(
                    torch, lambda: KA.flash_e2softmax_paged(*case, **kw),
                    flush)
                if pool == "bf16":
                    out["sdpa"][key] = paged_exact_vs_sdpa(
                        torch, case, kvmap, flush, causal)[1]


def moe_wave(torch) -> dict:
    """The ``moe`` kind: ``chip_smoke.profile_moe``'s paged wave of
    mixtral_8x7b (``MIXTRAL_LAYERS`` layers, seed-0 weights): wall and
    device busy in seconds, the expert FFN's device ms and share."""
    import dataclasses
    from chip_smoke import MIXTRAL_LAYERS, profile_moe
    from repro_torch.configs.base import get_config
    from repro_torch.models import api
    cfg = dataclasses.replace(get_config("mixtral_8x7b"),
                              n_layers=MIXTRAL_LAYERS)
    params = api.init_params(0, cfg, "cuda")
    prof = profile_moe(torch, cfg, params, "mixtral bf16")
    del params
    torch.cuda.empty_cache()
    return {k: prof[k] for k in ("wall_s", "device_busy_s", "expert_ffn_ms",
                                 "expert_ffn_share_of_busy",
                                 "kernels_per_forward")}


def static_norms(torch, gen, flush, out) -> None:
    """The ``qnorm`` kind: the static-params kernels on float32 rows by
    events into ``out["qnorm"]``, the bf16 op calls by events into
    ``out["static_ops"]`` and by host wall into ``out["static_ops_wall"]``."""
    import inspect
    from chip_smoke import NORM_CASES, STATIC_STAGE, time_ms, wall_ms
    from repro_torch import ops
    from repro_torch.core.sole.quant import calibrate_ptf
    from repro_torch.kernels import ailayernorm as KN
    takes_denom = "denom" in inspect.signature(KN.qnorm).parameters

    def case(rows, c, rms, dtype):
        def acts():
            x = torch.randn((rows, c), generator=gen, device="cuda") * 2
            x[:, ::7] *= 8
            return x.to(dtype)
        x = acts()
        r = torch.randn((rows, c), generator=gen, device="cuda").to(dtype)
        p = calibrate_ptf(acts(), unsigned=not rms)
        gamma = 1 + 0.1 * torch.randn((c,), generator=gen, device="cuda")
        beta = 0.1 * torch.randn((c,), generator=gen, device="cuda")
        return x, r, p, gamma, beta

    for rows, c, rms in NORM_CASES:
        x, r, p, gamma, beta = case(rows, c, rms, torch.float32)
        if takes_denom:
            chan = (p.denom().contiguous(), p.alpha, gamma,
                    torch.zeros_like(gamma) if rms else beta)
        else:
            chan = (p.scale, p.alpha, gamma, None if rms else beta)
        tag = f"{'rms' if rms else 'ln'}_{rows}x{c}"
        for name, fn, fargs in (("add_norm_quant", KN.add_norm_quant,
                                 (x, r) + chan),
                                ("qnorm", KN.qnorm, (x,) + chan),
                                ("add_norm", KN.add_norm, (x, r) + chan)):
            out["qnorm"][f"{name}_{tag}"] = time_ms(
                torch, lambda: fn(*fargs, rms=rms), flush)
    bf = torch.bfloat16
    for op, rows, c in STATIC_STAGE:
        rms = "rmsnorm" in op
        x, r, p, gamma, beta = case(rows, c, rms, bf)
        fn = ops.resolve(op, "sole", "cuda")
        head = (x, r) if op.startswith("residual_") else (x,)
        extra = () if rms else (beta,)

        def call():
            return fn(*head, gamma, *extra, params=p, out_dtype=bf)
        name = f"{op}_{rows}x{c}"
        out["static_ops"][name] = time_ms(torch, call, flush)
        out["static_ops_wall"][name] = wall_ms(torch, call, reps=300)


def exact_norms(torch, gen, flush, out) -> None:
    """The ``exact`` kind: the exact norm's forward calls by events into
    ``out["exact_fwd"]``, its backward calls into ``out["exact_bwd"]``."""
    from chip_smoke import (EXACT_NORM_CASES, NORM_BWD_CASES, TRAIN_BATCH,
                            TRAIN_SEQ, _bwd_inputs, time_ms)
    from repro_torch.kernels import ailayernorm as KN
    bf, f32 = torch.bfloat16, torch.float32
    # (name, rows, C, rms, groups, rows' type, out type)
    fwd = [(f"{'rms' if rms else 'ln'}{c}_rows{rows}", rows, c, rms, 1, bf,
            None) for c, rms in EXACT_NORM_CASES for rows in (8, 40, 2400)]
    fwd.append(("rms896_rows8192_train", TRAIN_BATCH * TRAIN_SEQ, 896, True,
                1, bf, bf))
    fwd += [(f"groupnorm_rows{rows}", rows, 64, False, 64, f32, None)
            for rows in (512, 8192, 153600)]
    for name, rows, c, rms, groups, dt, od in fwd:
        x, _, g, b = _bwd_inputs(torch, gen, rows, c, rms, groups, dt)
        eps = 1e-6 if rms else 1e-5
        out["exact_fwd"][name] = time_ms(
            torch, lambda: KN.exact_norm(x, g, b, rms=rms, eps=eps,
                                         out_dtype=od), flush)
    for name, row_counts, c, rms, groups in NORM_BWD_CASES:
        for dt in (f32, bf):
            for rows in row_counts:
                x, dy, g, b = _bwd_inputs(torch, gen, rows, c, rms, groups,
                                          dt)
                eps = 1e-6 if rms else 1e-5
                key = f"{name}_{'bf16' if dt == bf else 'f32'}_rows{rows}"
                out["exact_bwd"][key] = time_ms(
                    torch, lambda: KN.exact_norm_backward(x, g, b, dy,
                                                          rms=rms, eps=eps),
                    flush)


def calib_norms(torch, flush, out) -> None:
    """The ``calib`` kind: the calibrating norm's op calls by events into
    ``out["calib"]`` and by the profiler into ``out["calib_kernel"]``."""
    from chip_smoke import (CALIB_CASES, FAMILY_NORM_CASES, GROUPNORM_CASES,
                            _groupnorm_rows, profiled_kernel_ms, time_ms)
    from repro_torch import ops
    from repro_torch.kernels import ailayernorm as KN
    gen = torch.Generator(device="cuda").manual_seed(3)
    for rows, c, rms in (*CALIB_CASES.values(), *FAMILY_NORM_CASES.values(),
                         *CALIB_ONE_ROW.values()):
        x = torch.randn((rows, c), generator=gen, device="cuda") * 3
        x[:, ::7] *= 8                         # outlier channels, alpha > 0
        x = x.to(torch.bfloat16)
        r = torch.randn((rows, c), generator=gen, device="cuda").to(x.dtype)
        gamma = 1 + 0.1 * torch.randn((c,), generator=gen, device="cuda")
        extra = () if rms else (0.1 * torch.randn((c,), generator=gen,
                                                  device="cuda"),)
        stage = ops.resolve("residual_rmsnorm" if rms
                            else "residual_layernorm", "sole", "cuda")

        def run():
            return stage(x, r, gamma, *extra, out_dtype=x.dtype)
        key = f"{'rms' if rms else 'ln'}{c}_rows{rows}"
        out["calib"][key] = time_ms(torch, run, flush)
        out["calib_kernel"][key] = profiled_kernel_ms(torch, run, flush,
                                                      "calib_norm_kernel")
    for rows in (*GROUPNORM_CASES.values(), 64):
        x, g, b = _groupnorm_rows(torch, gen, rows)

        def run():
            return KN.calibrated_norm(x, None, g, b, rms=False)
        key = f"groupnorm_rows{rows}"
        out["calib"][key] = time_ms(torch, run, flush)
        out["calib_kernel"][key] = profiled_kernel_ms(torch, run, flush,
                                                      "calib_norm_kernel")


def e2_stage(torch, cfg, gen, flush, out) -> None:
    """The ``e2`` kind: the kernel alone and the ``_sole_probs`` stage at
    the dense path's decode and prefill inputs (``chip_smoke``'s), by
    events into ``out["e2"]`` and by host wall into ``out["e2_wall"]``."""
    import inspect
    from chip_smoke import dense_stage_inputs, time_ms, wall_ms
    from repro_torch import ops
    from repro_torch.kernels import e2softmax as KE
    from repro_torch.models import layers as L
    bf = torch.bfloat16
    folded = "out_dtype" in inspect.signature(L._sole_probs).parameters
    for name, inp in dense_stage_inputs(torch, cfg, gen).items():
        logits, mask = inp["logits"], inp["mask"]
        c = logits.shape[-1]
        m = torch.where(mask, logits, -torch.inf).amax(-1, keepdim=True)
        x = ops.snap_logits(logits - torch.clamp_min(m, -1e30),
                            L.LOGIT_INT8_SCALE).reshape(-1, c)
        full = torch.broadcast_to(mask, logits.shape).reshape(-1, c)

        def kernel():
            return KE.e2softmax(x, exp_bits=cfg.exp_bits, mask=full)

        def stage():
            if folded:
                return L._sole_probs(logits, mask, cfg, bf)
            return L._sole_probs(logits, mask, cfg).to(bf)
        for label, fn in (("kernel", kernel), ("stage", stage)):
            out["e2"][f"{label}_{name}"] = time_ms(torch, fn, flush)
            out["e2_wall"][f"{label}_{name}"] = wall_ms(torch, fn, reps=300)


def waves(torch, cfg) -> dict:
    """Host wall seconds of one decode-heavy wave (8 requests of 128-token
    prompts, 32 new tokens each, as ``chip_smoke.py`` profiles it) through
    ``PagedEngine`` and the dense-slot ``Engine`` at qwen2_0_5b's full
    width, in bf16 and at w8a8 with int8 pages, and through
    ``PagedEngine`` at minitron_8b's in bf16, after a warm-up request; from
    the same wave under the profiler, device kernels per forward, device
    busy seconds and the calibrating norm's share of them."""
    import dataclasses
    import numpy as np
    from chip_smoke import (BLOCK_SIZE, DECODE_BATCH, DENSE_MAX_LEN,
                            MAX_SEQ_LEN, NEW_TOKENS, PREFILL_CHUNK,
                            device_rows, is_dense_e2)
    from repro_torch.configs.base import QuantConfig, get_config
    from repro_torch.models import api
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve.engine import Engine, PagedEngine, Request
    res = {}
    cfg8 = dataclasses.replace(cfg, quant=QuantConfig("w8a8"),
                               kv_cache_dtype="int8")
    for label, c in (("paged_bf16", cfg), ("paged_w8a8", cfg8),
                     ("dense_bf16", cfg), ("dense_w8a8", cfg8),
                     ("minitron_paged_bf16", get_config("minitron_8b"))):
        params = api.init_params(0, c, "cuda")
        dense = label.startswith("dense")
        if dense:
            eng = Engine(c, params, batch_size=DECODE_BATCH,
                         max_len=DENSE_MAX_LEN, device="cuda")
        else:
            eng = PagedEngine(c, params,
                              num_blocks=8 * MAX_SEQ_LEN // BLOCK_SIZE + 1,
                              block_size=BLOCK_SIZE, max_seq_len=MAX_SEQ_LEN,
                              max_running=8, decode_batch=DECODE_BATCH,
                              prefill_chunk=PREFILL_CHUNK, decode_horizon=8,
                              device="cuda")
        rng = np.random.default_rng(2)
        reqs = [Request(prompt=rng.integers(0, c.vocab_size, 128)
                        .astype(np.int32), max_new_tokens=NEW_TOKENS)
                for _ in range(DECODE_BATCH)]
        eng.generate(reqs[:1])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = eng.generate(reqs)
        torch.cuda.synchronize()
        res[label] = time.perf_counter() - t0
        if sum(len(o) for o in outs) != DECODE_BATCH * NEW_TOKENS:
            raise AssertionError(f"{label}: token counts")
        # device kernels per forward (one attention launch per layer: the
        # paged kernel, or the dense engine's E2Softmax), from the same
        # wave under the profiler
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            eng.generate(reqs)
            torch.cuda.synchronize()
        rows = device_rows(torch, prof)
        forwards = sum(n for _, n, k in rows
                       if (is_dense_e2(k) if dense
                           else "paged_e2softmax" in k)) / c.n_layers
        res[f"{label}_kernels_per_forward"] = \
            sum(n for _, n, _ in rows) / forwards
        busy = sum(us for us, _, _ in rows) / 1e6
        res[f"{label}_busy_s"] = busy
        calib = [(us, n, k) for us, n, k in rows if "calib_norm_kernel" in k]
        res[f"{label}_calib_share"] = sum(us for us, _, _ in calib) / 1e6 / busy
        res[f"{label}_calib_launches"] = sum(n for _, n, _ in calib)
        res[f"{label}_calib_us"] = (sum(us for us, _, _ in calib)
                                    / max(1, sum(n for _, n, _ in calib)))
        for route, tag in (("grid", ", true>"), ("cluster", ", false>")):
            mine = [(us, n) for us, n, k in calib if tag in k]
            if mine:
                res[f"{label}_calib_launches_{route}"] = sum(n for _, n in mine)
                res[f"{label}_calib_us_{route}"] = (sum(us for us, _ in mine)
                                                    / sum(n for _, n in mine))
        del eng, params
        torch.cuda.empty_cache()
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", help="root of the other checkout")
    ap.add_argument("--only", default=",".join(KINDS),
                    help="comma-separated kinds to time (default: all)")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    kinds = [k for k in args.only.split(",") if k]
    if set(kinds) - set(KINDS):
        ap.error(f"--only takes {KINDS}")
    if args.worker:
        print(json.dumps(worker(args.worker, kinds)))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device available", file=sys.stderr)
        return 2
    if not args.base:
        ap.error("--base is required")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    trees = {"base": os.path.abspath(args.base), "this": ROOT}
    turns = []
    for label in ("base", "this", "this", "base"):
        src = os.path.join(trees[label], "src")
        t0 = time.time()
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--worker", src, "--only", ",".join(kinds)],
                             capture_output=True,
                             text=True, timeout=900)
        if res.returncode != 0:
            print(res.stdout[-4000:], res.stderr[-4000:], file=sys.stderr)
            return 1
        turns.append((label, json.loads(res.stdout.strip().splitlines()[-1])))
        print(f"turn {len(turns)} ({label}): {time.time() - t0:.1f} s",
              flush=True)
    for kind in ("paged", "sweep", "norm", "norm_wall", "flash", "gemm",
                 "e2", "e2_wall", "qnorm", "static_ops", "static_ops_wall",
                 "exact_fwd", "exact_bwd", "calib", "calib_kernel", "wave",
                 "moe"):
        for name in dict.fromkeys(n for _, t in turns for n in t[kind]):
            if all(t[kind].get(name) is not None for lb, t in turns
                   if lb == "this") and all(name not in t[kind]
                                            for lb, t in turns if lb == "base"):
                vals = [t[kind][name] for lb, t in turns if lb == "this"]
                print(f"{kind} {name}: this {sum(vals) / len(vals):.2f} "
                      "(base has none)")
                continue
            if any(t[kind].get(name) is None for _, t in turns):
                print(f"{kind} {name}: not measured (the profiler kept no "
                      "record in a turn)")
                continue
            mean = {lab: sum(t[kind][name] for lb, t in turns if lb == lab)
                    / 2 for lab in ("base", "this")}
            lib = {"flash": "sdpa", "gemm": "int_mm",
                   "paged": "sdpa"}.get(kind, "none")
            libs = [t[lib][name] for _, t in turns if name in t.get(lib, {})]
            unit = "s" if kind == "wave" else "us"
            scale = 1 if kind == "wave" else 1e3
            if name.endswith("_per_forward"):
                unit, scale = "kernels", 1
            if name.endswith("_share") or "_calib_launches" in name:
                unit, scale = "", 1
            if "_calib_us" in name:
                unit, scale = "us", 1
            if kind == "moe":                  # named by their units
                unit, scale = "", 1
            print(f"{kind} {name}: base {mean['base'] * scale:.2f} {unit}, "
                  f"this {mean['this'] * scale:.2f} {unit}, base/this "
                  f"{mean['base'] / mean['this']:.2f}, this/base "
                  f"{mean['this'] / mean['base']:.3f}"
                  + (f"; {lib} {sum(libs) / len(libs) * 1e3:.2f} us"
                     if libs else ""))
    print(smi)
    print(json.dumps({"device": smi, "turns": turns}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
