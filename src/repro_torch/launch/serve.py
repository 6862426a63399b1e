"""Serving launcher: batched generation with SOLE active, greedy or
sampled (``--temperature``/``--top-k``), on the card unless ``--device
cpu`` is given.

The port's counterpart of ``repro/launch/serve.py``, with the flags the
port supports; ``--engine dense`` (the dense-slot ``Engine``) is the
default, as in the reference. Examples::

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2_0_5b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2_0_5b \
      --engine paged --quantize w8a8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2_0_5b \
      --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch minitron_8b \
      --smoke --device cpu --temperature 0.7 --top-k 5

``--arch`` takes the ported configs (``qwen2_0_5b``, ``stablelm_1_6b``,
``minitron_8b``, ``nemotron_4_15b``). Not ported yet (ROADMAP.md queue 1
item 6): ``--open-loop``, ``--stream``, ``--watermark``,
``--spec-decode``, ``--spec-k``, ``--mesh``, ``--replicas``,
``--ops-backend``.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ARCH_NAMES, QuantConfig, get_config
from repro_torch.models import api
from repro_torch.serve.engine import Engine, PagedEngine, Request


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True,
                    help="a ported config: " + ", ".join(ARCH_NAMES))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--engine", choices=("dense", "paged"), default="dense",
                    help="dense-slot baseline or paged continuous batching")
    ap.add_argument("--decode-horizon", type=int, default=8,
                    help="max fused greedy decode steps per dispatch "
                         "(paged engine)")
    ap.add_argument("--prefix-cache", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="share identical block-aligned prompt prefixes "
                         "(paged engine; default: on for the dense family)")
    ap.add_argument("--num-blocks", type=int, default=0,
                    help="KV pool pages (0 = sized from the request set)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0 = greedy argmax)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="restrict sampling to the k highest logits "
                         "(0 = full vocab)")
    ap.add_argument("--sample-seed", type=int, default=0,
                    help="base seed for per-request sampling streams")
    ap.add_argument("--eos-ids", default="",
                    help="comma-separated token ids that end a request "
                         "early (finish reason 'eos')")
    ap.add_argument("--quantize", choices=("off", "w8a16", "w8a8"),
                    default="off",
                    help="w8a16: int8 projection weights; w8a8: also int8 "
                         "activations into the matmuls (off = float serving)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (cuda unless asked)")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> List[List[int]]:
    """Serve ``--requests`` random prompts and print a summary; returns the
    generated token lists in request order."""
    args = parse_args(argv)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    if args.quantize != "off":
        cfg = dataclasses.replace(cfg, quant=QuantConfig(mode=args.quantize))
    device = torch.device(args.device)
    params = api.init_params(args.seed, cfg, device)
    rng = np.random.default_rng(args.seed)
    eos_ids = tuple(int(t) for t in args.eos_ids.split(",") if t.strip())
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size,
                                        size=args.prompt_len).astype(np.int32),
                    max_new_tokens=args.new_tokens,
                    temperature=args.temperature, top_k=args.top_k,
                    seed=args.sample_seed + i, eos_ids=eos_ids)
            for i in range(args.requests)]
    max_len = args.prompt_len + args.new_tokens
    if args.engine == "paged":
        blocks = args.num_blocks or max(
            args.requests * ((max_len + 15) // 16 + 1), 16)
        eng = PagedEngine(cfg, params, num_blocks=blocks, block_size=16,
                          max_seq_len=max_len, max_running=args.batch,
                          decode_batch=args.batch,
                          decode_horizon=args.decode_horizon,
                          prefix_cache=args.prefix_cache, device=device)
    else:
        eng = Engine(cfg, params, batch_size=args.batch, max_len=max_len,
                     device=device)
    t0 = time.perf_counter()
    outs = eng.generate(reqs)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    total = sum(len(o) for o in outs)
    print(f"arch={cfg.name} engine={args.engine} device={device} "
          f"requests={len(reqs)} generated={total} tokens in {dt:.2f}s "
          f"({total / dt:.1f} tok/s, softmax={cfg.softmax_mode}, "
          f"norm={cfg.norm_mode}, quant={cfg.quant.mode}, "
          f"temperature={args.temperature}, top_k={args.top_k})")
    if args.engine == "paged":
        print("stats:", eng.stats())
    else:
        print("finish_reasons:", eng.finish_reasons)
    for o in outs[:2]:
        print("sample:", o)
    return outs


if __name__ == "__main__":
    main()
