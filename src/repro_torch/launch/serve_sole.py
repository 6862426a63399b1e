"""End-to-end serving driver, the port's counterpart of
``examples/serve_sole.py``: a request trace through the paged
continuous-batching engine with the SOLE pipeline (E2Softmax attention +
AILayerNorm) active, the paper's deployment scenario.

Decode and chunked-prefill attention stream KV pages through the paged
Flash-E2Softmax kernel on the card; pages are admitted and reclaimed by
the scheduler, so the pool holds only live tokens. The example's engine
settings, at seed 0: 48 pages of 8 tokens, ``max_seq_len`` 64, 8 running,
decode batches of 4, prefill chunks of 8; ``--dense`` also runs the
dense-slot ``Engine`` (batches of 4, 64-column caches).

Run:
  PYTHONPATH=src python -m repro_torch.launch.serve_sole [--arch qwen2_0_5b]
  PYTHONPATH=src python -m repro_torch.launch.serve_sole --device cpu --dense

``--backend`` is the op backend (``auto``: the kernels on the card, plain
torch on the CPU; ``reference``: the plain versions everywhere; ``cuda``:
``auto`` refusing the CPU). :func:`main` takes a config (default: the
arch's smoke config) and parameters (default: ``init_params`` at seed 0)
and returns the outputs.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, get_config
from repro_torch.models import api
from repro_torch.ops import CHOICES
from repro_torch.serve.engine import Engine, PagedEngine, Request

PAGED = dict(num_blocks=48, block_size=8, max_seq_len=64, max_running=8,
             decode_batch=4, prefill_chunk=8)
DENSE = dict(batch_size=4, max_len=64)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2_0_5b")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--new-tokens", type=int, default=12)
    ap.add_argument("--backend", default="auto", choices=CHOICES)
    ap.add_argument("--dense", action="store_true",
                    help="also run the dense-slot baseline engine")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def requests(cfg: ArchConfig, n: int, new_tokens: int):
    """The example's trace: prompts of 8-12 tokens from seed 0."""
    rng = np.random.default_rng(0)
    return [Request(prompt=rng.integers(0, cfg.vocab_size, size=8 + i % 5)
                    .astype(np.int32), max_new_tokens=new_tokens)
            for i in range(n)]


def _timed(fn, device):
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, time.perf_counter() - t0


def main(argv: Optional[Sequence[str]] = None,
         cfg: Optional[ArchConfig] = None, params=None) -> dict:
    args = parse_args(argv)
    device = torch.device(args.device)
    if cfg is None:
        cfg = get_config(args.arch).smoke()   # CPU-runnable reduced config
    cfg = dataclasses.replace(cfg, ops_backend=args.backend)
    print(f"arch={cfg.name} softmax={cfg.softmax_mode} norm={cfg.norm_mode} "
          f"(SOLE active in the serve phase) device={device}")
    if params is None:
        params = api.init_params(0, cfg, device)
    reqs = requests(cfg, args.requests, args.new_tokens)

    eng = PagedEngine(cfg, params, device=device, **PAGED)
    outs, dt = _timed(lambda: eng.generate(reqs), device)
    n = sum(len(o) for o in outs)
    res = {"paged": outs, "paged_tokens": n, "paged_s": dt,
           "peak_pages": eng.cache.peak_blocks_in_use, "steps": eng.steps}
    print(f"paged[{args.backend}]: {len(reqs)} requests, {n} tokens in "
          f"{dt:.2f}s ({n / dt:.1f} tok/s on {device.type}) — peak pages "
          f"{eng.cache.peak_blocks_in_use}/{eng.cache.num_blocks - 1}, "
          f"{eng.steps} engine steps")
    print("sample continuations:", outs[0][:8], outs[1][:8])

    if args.dense:
        deng = Engine(cfg, params, device=device, **DENSE)
        douts, ddt = _timed(lambda: deng.generate(reqs), device)
        dn = sum(len(o) for o in douts)
        res.update(dense=douts, dense_tokens=dn, dense_s=ddt)
        print(f"dense-slot baseline: {dn} tokens in {ddt:.2f}s "
              f"({dn / ddt:.1f} tok/s, batch of 4 x max_len 64 cache)")
    return res


if __name__ == "__main__":
    main()
