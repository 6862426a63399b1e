"""Serving launcher: batched generation with SOLE active, greedy or
sampled (``--temperature``/``--top-k``), on the card unless ``--device
cpu`` is given.

The port's counterpart of ``repro/launch/serve.py``, with the flags the
port supports; ``--engine dense`` (the dense-slot ``Engine``) is the
default, as in the reference. The paged engine also serves speculatively
(``--spec-decode ngram|draft|draft:<arch>``, ``--spec-k``) and open-loop
(``--open-loop RATE``: Poisson arrivals from ``--seed`` through
``AsyncEngine``, ``--stream`` prints tokens as they surface,
``--replicas N`` puts N engines on one card behind the prefix router).
Examples::

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2_0_5b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2_0_5b \
      --engine paged --quantize w8a8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2_0_5b \
      --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch minitron_8b \
      --smoke --device cpu --temperature 0.7 --top-k 5
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2_0_5b \
      --engine paged --spec-decode ngram --open-loop 0.5 --stream

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral_8x7b \
      --smoke --device cpu --engine paged --spec-decode ngram

  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6_7b \
      --smoke --device cpu --engine paged
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch recurrentgemma_9b --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper_small \
      --smoke --device cpu --engine paged

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2_0_5b \
      --smoke --device cpu --engine paged --mesh 1,2
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2_0_5b \
      --engine paged --mesh 1,2 --dist-backend gloo
  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.serve \
      --arch qwen2_0_5b --engine paged --mesh 1,2
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2_0_5b \
      --smoke --device cpu --engine paged --mesh 2,2
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2_0_5b \
      --smoke --device cpu --engine dense --mesh 1,2
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral_8x7b \
      --smoke --device cpu --engine paged --mesh 2,2

``--arch`` takes the ported configs (``qwen2_0_5b``, ``stablelm_1_6b``,
``minitron_8b``, ``nemotron_4_15b``, the MoE ``mixtral_8x7b``,
``dbrx_132b``, the ssm ``rwkv6_7b``, the hybrid ``recurrentgemma_9b``,
the encdec ``whisper_small`` and the vlm ``qwen2_vl_7b``; MoE with
``--quantize`` raises, as the reference has no quantized MoE path; the
recurrent families and encdec raise, as the reference's engines do, on
``--quantize``, ``--spec-decode`` and on ``--prefix-cache`` beyond what
their state spec allows). ``whisper_small`` is served by ``--engine
paged`` only, each request with synthetic (cross_len, d_model) encoder
frames from ``--seed``; ``--engine dense`` refuses it and both engines
refuse ``qwen2_vl_7b`` (not paged-servable), with the reference's
messages.

``--mesh D,M`` serves the dense and MoE families on a (data, model) mesh
of D x M ranks (``launch/mesh.py``), through either engine:
tensor-parallel over the M ranks of the model axis, each dispatch's lanes
split over the D ranks of the data axis where D divides them, and the MoE
experts laid over the data axis (``models/moe.py``). Under ``torchrun``
(``WORLD_SIZE`` set) each process is one rank, otherwise the launcher
spawns the D x M ranks itself. On the CPU they join over gloo; on CUDA
over nccl, one card a rank, or over gloo sharing the cards with
``--dist-backend gloo`` (asked for explicitly: fewer cards than ranks
raise otherwise). The weights are drawn in host memory, so each card
holds only its rank's slices. Rank 0 prints what the single-device
launcher prints.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ARCH_NAMES, QuantConfig, get_config
from repro_torch.launch import mesh as M
from repro_torch.models import api
from repro_torch.ops import CHOICES
from repro_torch.serve.engine import Engine, PagedEngine, Request
from repro_torch.serve.loop import AsyncEngine, ReplicatedAsyncEngine
from repro_torch.serve.spec import spec_config_from_flag


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
                         "(paged engine; default: what the family supports; "
                         "recurrent families restore state checkpoints)")
    ap.add_argument("--watermark", type=int, default=1,
                    help="free pages held back at admission; higher = "
                         "fewer preemptions, lower = denser packing")
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
    ap.add_argument("--open-loop", type=float, default=0.0, metavar="RATE",
                    help="serve through the AsyncEngine loop with Poisson "
                         "arrivals at RATE requests per engine step (paged "
                         "engine; 0 = closed batch)")
    ap.add_argument("--stream", action="store_true",
                    help="print tokens as they surface (open-loop mode)")
    ap.add_argument("--spec-decode", default="", metavar="MODE",
                    help="speculative decoding (paged engine): 'ngram' = "
                         "prompt-lookup drafting, 'draft:<arch>' = a draft "
                         "model sharing the target's vocab, 'draft' = "
                         "self-draft with the target's architecture")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="max draft tokens per lane per verify dispatch")
    ap.add_argument("--ops-backend", choices=CHOICES, default="auto",
                    help="op backend: auto = the kernels on a CUDA device "
                         "and plain torch on the CPU; reference = plain "
                         "torch everywhere; cuda = the kernels, refusing "
                         "the CPU")
    ap.add_argument("--replicas", type=int, default=1,
                    help="PagedEngine replicas on the device behind one "
                         "prefix-routed front door (paged open-loop only; "
                         "params are shared)")
    ap.add_argument("--quantize", choices=("off", "w8a16", "w8a8"),
                    default="off",
                    help="w8a16: int8 projection weights; w8a8: also int8 "
                         "activations into the matmuls (off = float serving)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (cuda unless asked)")
    ap.add_argument("--mesh", default="", metavar="D,M",
                    help="serve on a (data, model) mesh of D x M ranks "
                         "(dense and MoE families): tensor-parallel over "
                         "M, lanes split over D")
    ap.add_argument("--dist-backend", choices=("nccl", "gloo"), default=None,
                    help="process group backend under --mesh (default: "
                         "gloo on the CPU, nccl with a card per rank; gloo "
                         "lets ranks share a card)")
    return ap.parse_args(argv)


def mesh_shape(flag: str):
    """``--mesh D,M`` -> (D, M)."""
    try:
        shape = tuple(int(x) for x in flag.split(","))
    except ValueError:
        raise SystemExit(f"--mesh takes D,M, got {flag!r}") from None
    if len(shape) != 2 or min(shape) < 1:
        raise SystemExit(f"--mesh takes D,M, got {flag!r}")
    return shape


def _mesh_rank(rank: int, world: int, argv, backend: str):
    """One spawned rank of ``--mesh``: its group is up (``M.spawn``)."""
    return _serve(parse_args(argv), backend, rank)


def main(argv: Optional[Sequence[str]] = None) -> List[List[int]]:
    """Serve ``--requests`` random prompts and print a summary; returns the
    generated token lists in request order (rank 0's under ``--mesh``)."""
    args = parse_args(argv)
    if not args.mesh:
        return _serve(args)
    shape = mesh_shape(args.mesh)
    world = shape[0] * shape[1]
    backend = M.pick_backend(world, args.device, args.dist_backend)
    env = M.world_from_env()
    if env is not None:                  # torchrun: this process is a rank
        rank, size = env
        if size != world:
            raise SystemExit(f"--mesh {args.mesh} needs {world} ranks, "
                             f"torchrun started {size}")
        torch.distributed.init_process_group(backend)
        if backend == "nccl":
            torch.cuda.set_device(M.rank_device(args.device, backend, rank))
        try:
            return _serve(args, backend, rank)
        finally:
            torch.distributed.destroy_process_group()
    threads = max(1, (os.cpu_count() or 1) // world)
    outs = M.spawn(_mesh_rank, world, (argv, backend), backend=backend,
                   timeout=24 * 3600, threads=threads)
    return outs[0]


def _serve(args, backend: Optional[str] = None,
           rank: int = 0) -> List[List[int]]:
    """The serving run of one process: the whole model, or (``backend``
    set, the process group up) rank ``rank`` of ``--mesh``'s model, which
    prints only on rank 0."""
    rules = None
    device = torch.device(args.device)
    if backend is not None:
        device = M.rank_device(args.device, backend, rank)
        rules = M.make_rules(M.make_mesh(mesh_shape(args.mesh),
                                         ("data", "model")))
    echo = print if rank == 0 else (lambda *a, **k: None)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    cfg = dataclasses.replace(cfg, ops_backend=args.ops_backend)
    if args.quantize != "off":
        cfg = dataclasses.replace(cfg, quant=QuantConfig(mode=args.quantize))
    paged = args.engine == "paged"
    if args.replicas > 1 and not (paged and args.open_loop > 0):
        raise SystemExit("--replicas requires --engine paged --open-loop")
    if (args.spec_decode or args.open_loop > 0) and not paged:
        raise SystemExit("--spec-decode and --open-loop require "
                         "--engine paged")
    # under a mesh the weights are drawn in host memory (a CPU generator:
    # other draws than the card's) and each rank moves only its slices
    params = api.init_params(args.seed, cfg,
                             device if rules is None else "cpu")
    rng = np.random.default_rng(args.seed)
    eos_ids = tuple(int(t) for t in args.eos_ids.split(",") if t.strip())
    # encdec requests carry synthetic encoder frames (the paged engine
    # encodes them once at admission and parks cross K/V in pages)
    cross = api.sequence_state_spec(cfg).cross_tokens if paged else 0

    def frames():
        if not cross:
            return None
        return rng.standard_normal((cross, cfg.d_model)).astype(np.float32)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size,
                                        size=args.prompt_len).astype(np.int32),
                    max_new_tokens=args.new_tokens,
                    temperature=args.temperature, top_k=args.top_k,
                    seed=args.sample_seed + i, eos_ids=eos_ids,
                    frames=frames())
            for i in range(args.requests)]
    max_len = args.prompt_len + args.new_tokens
    if paged:
        blocks = args.num_blocks or max(
            args.requests * ((max_len + 15) // 16 + 1 + (cross + 15) // 16),
            16)
        spec = spec_config_from_flag(args.spec_decode, cfg,
                                     max_k=args.spec_k, seed=args.seed,
                                     smoke=args.smoke, device=device,
                                     rules=rules)

        def make_engine(p):
            return PagedEngine(cfg, p, num_blocks=blocks, block_size=16,
                               max_seq_len=max_len, max_running=args.batch,
                               decode_batch=args.batch,
                               decode_horizon=args.decode_horizon,
                               prefix_cache=args.prefix_cache,
                               watermark=args.watermark, spec_config=spec,
                               device=device, rules=rules)
        eng = make_engine(params)
        # replicas share the engine's device-resident parameter tree; each
        # owns its KV pool, scheduler and prefix cache
        engines = [eng] + [make_engine(eng.params)
                           for _ in range(args.replicas - 1)]
    else:
        eng = Engine(cfg, params, batch_size=args.batch, max_len=max_len,
                     device=device, rules=rules)
    mode = (f"softmax={cfg.softmax_mode}, norm={cfg.norm_mode}, "
            f"quant={cfg.quant.mode}, ops_backend={cfg.ops_backend}, "
            f"temperature={args.temperature}, top_k={args.top_k}, "
            f"spec={args.spec_decode or 'off'}")
    if rules is not None:
        mode += f", mesh={args.mesh} ({backend})"
    if args.open_loop > 0:
        return _open_loop(args, engines, reqs, rng, device, cfg, mode, echo)
    t0 = time.perf_counter()
    outs = eng.generate(reqs)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    total = sum(len(o) for o in outs)
    echo(f"arch={cfg.name} engine={args.engine} device={device} "
         f"requests={len(reqs)} generated={total} tokens in {dt:.2f}s "
         f"({total / dt:.1f} tok/s, {mode})")
    if paged:
        echo("stats:", eng.stats())
    else:
        echo("finish_reasons:", eng.finish_reasons)
    for o in outs[:2]:
        echo("sample:", o)
    return outs


def _open_loop(args, engines, reqs, rng, device, cfg, mode,
               echo=print) -> List[List[int]]:
    """Serve ``reqs`` through ``AsyncEngine`` (or ``ReplicatedAsyncEngine``
    over ``engines``) with Poisson arrivals at ``--open-loop`` requests per
    engine step; print latency percentiles and return the tokens in
    request order."""
    loop = (ReplicatedAsyncEngine(engines) if len(engines) > 1
            else AsyncEngine(engines[0]))
    arrivals = np.cumsum(
        rng.exponential(1.0 / args.open_loop, len(reqs))).astype(int)
    on_token = None
    if args.stream:
        def on_token(h, tok):
            echo(f"  req@{h.arrival} -> {tok}")
    t0 = time.perf_counter()
    handles = [loop.add_request(r, arrival=int(a), on_token=on_token)
               for r, a in zip(reqs, arrivals)]
    loop.run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    outs = [h.tokens for h in handles]
    total = sum(len(o) for o in outs)
    st = loop.stats()
    echo(f"arch={cfg.name} engine=paged(open-loop) device={device} "
         f"replicas={len(engines)} requests={len(reqs)} generated={total} "
         f"tokens in {dt:.2f}s ({total / dt:.1f} tok/s, {mode})")
    if len(engines) > 1:
        echo(f"routing: {st['routed_by_prefix']} by prefix, "
             f"{st['routed_by_load']} by load")
        for i, rep in enumerate(st["per_replica"]):
            echo(f"  replica {i}: completed={rep['completed']} "
                 f"decode_tokens={rep['engine']['decode_tokens']} "
                 f"prefix_hit_rate={rep['engine']['prefix_hit_rate']}")
        return outs
    echo(f"finish_reasons: {st['finish_reasons']}")
    for key in ("ttft", "itl"):
        echo(f"{key.upper()} steps p50/p99: {st[key + '_steps']['p50']}/"
             f"{st[key + '_steps']['p99']}  ms: {st[key + '_ms']['p50']}/"
             f"{st[key + '_ms']['p99']}")
    echo("engine stats:", st["engine"])
    return outs


if __name__ == "__main__":
    main()
