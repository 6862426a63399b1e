#!/usr/bin/env python3
"""Time the port's dense Flash-E2Softmax and int8 GEMM kernels from two
checkouts on one NVIDIA GPU, in turns (base, this, this, base), so two
versions are compared inside one run on one card. Run from the root of a
checkout, with another checkout of the repository at ``BASE``::

    python3 kernel_ab.py --base BASE

Each turn is a fresh process that puts ``<checkout>/src`` first on the
path, builds that checkout's kernels there (``kernels/build.py``) and
times, with CUDA events and the L2 cache flushed before each launch, the
dense flash kernel on bf16 inputs at the op layer's shapes (qwen2_0_5b's
2048-token causal attention in four modes, a ragged non-causal case,
stablelm_1_6b's MHA) and the int8 GEMM at every (M, K, N) of the w8a8
path (M = 8 and 128), beside ``scaled_dot_product_attention`` (exact
mode) and ``torch._int_mm`` (at M = 8 on the activation zero-padded to
24 rows: it refuses M <= 16) on the same inputs. Inputs come from fixed
seeds, alike in every turn. Prints one line per shape (the mean of each
checkout's two turns, and their ratio), the ``nvidia-smi`` line and one
JSON object with every turn's times.
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


def worker(src: str) -> dict:
    """One turn: the kernels of the checkout whose package is under
    ``src``, timed at every shape."""
    sys.path.insert(0, src)
    import torch
    import torch.nn.functional as F
    from chip_smoke import FLASH_CASES, GEMM_KN, INT_MM_MIN_M, time_ms
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_e2softmax as KA
    from repro_torch.kernels import int8_matmul as KM
    from repro_torch.models.layers import LOGIT_INT8_SCALE
    if not KA.__file__.startswith(src):
        raise RuntimeError(f"imported {KA.__file__}, not from {src}")
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all(["flash_e2softmax", "int8_matmul"])
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda").zero_
    gen = torch.Generator(device="cuda").manual_seed(15)
    out = {"flash": {}, "gemm": {}, "sdpa": {}, "int_mm": {}}
    for case, mode in FLASH:
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
    for m in (8, 128):
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", help="root of the other checkout")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.worker)))
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
                              "--worker", src], capture_output=True,
                             text=True, timeout=900)
        if res.returncode != 0:
            print(res.stdout[-4000:], res.stderr[-4000:], file=sys.stderr)
            return 1
        turns.append((label, json.loads(res.stdout.strip().splitlines()[-1])))
        print(f"turn {len(turns)} ({label}): {time.time() - t0:.1f} s",
              flush=True)
    for kind in ("flash", "gemm"):
        for name in turns[0][1][kind]:
            mean = {lab: sum(t[kind][name] for lb, t in turns if lb == lab)
                    / 2 for lab in ("base", "this")}
            lib = {"flash": "sdpa", "gemm": "int_mm"}[kind]
            libs = [t[lib][name] for _, t in turns if name in t[lib]]
            print(f"{kind} {name}: base {mean['base'] * 1e3:.2f} us, this "
                  f"{mean['this'] * 1e3:.2f} us, base/this "
                  f"{mean['base'] / mean['this']:.2f}"
                  + (f"; {lib} {sum(libs) / len(libs) * 1e3:.2f} us"
                     if libs else ""))
    print(smi)
    print(json.dumps({"device": smi, "turns": turns}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
