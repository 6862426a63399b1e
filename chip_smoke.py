#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU. Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, each fatal on failure (exit code 1, no result line):

1. the card's name and power limit (``nvidia-smi``);
2. build the five CUDA sources from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, started together), print ``-Xptxas -v`` and count
   the tensor-core instructions in the paged and dense flash and int8
   GEMM kernels' SASS (``cuobjdump -sass``; the bf16 flash kernels and
   the paged kernel's instantiations at head dims 64, 128 and 256 must
   issue bf16 ``HMMA``);
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
tensor cores with q in three bf16 parts, SOLE held to a share of rows)
over bf16 and int8 pools,
the calibrating norm at LayerNorm widths 4,096 and 6,144, the int8 GEMM at
minitron_8b's shapes (K 16,384, the 256,000-entry head) and the dense
path's ``_sole_probs`` at its heads; then minitron_8b at full width (32
layers) through ``PagedEngine`` in bf16 and at w8a8 with int8 KV, through
the dense-slot ``Engine`` in bf16, three stochastic replays (exact mode;
cold, warm prefix cache, forced preemption; the device draws against the
host ``Sampler``), an 8,192-token prefill on the blocked attention against
the dense one, a profiled wave; and nemotron_4_15b (48 heads, 6,144
wide) through ``PagedEngine`` in bf16, each model freed before the next.

Speculative decoding and the streaming front end join phases 3-5: the
paged kernel at the verify dispatch's shapes (8 lanes x C = 2, 3, 5, 9
causal rows, a q_start per lane, ragged n_valid, null lanes; bf16 and
int8 pages; qwen2_0_5b's head dim 64 and minitron_8b's 128) against its
plain version, its C > 1 route against its C = 1 route on the same query
rows (bitwise share printed), the calibrating norm at 40 rows of 896 and
4,096 and the int8 GEMM at M = 40; then qwen2_0_5b at full width through
``PagedEngine`` with speculation beside the plain run in the same call
(exact mode: an oracle, an anti-oracle and the n-gram drafter in bf16,
the oracle and n-gram at w8a8 + int8 KV; SOLE bf16 n-gram), exact
mode's tokens equal to plain decode's, the launches of each verify
dispatch checked, a profiled spec trace and the first op where a verify
slot and a decode step part; an open-loop Poisson trace through
``AsyncEngine``
with two cancellations and then two replicas on the card; nemotron_4_15b
with a minitron_8b draft model; and the smoke spec engine and
``AsyncEngine`` on the card against the CPU.

Row stability of speculative verify against decode (phase 3): the
model's verify attention (``layers.paged_attend`` with ``rows_as_decode``:
the B x C rows as single-row decode queries) held bitwise to the decode
step at each row's position, at head dim 64 and 128, on bf16, int8 and
int8 + ``quant_pv`` pages, SOLE and exact, and timed beside the old
chunk route; the exact-mode norm kernel bitwise equal per row at 1, 8,
40, 128 and 2,400 rows of 896, 4,096 and 6,144 channels (RMS and
LayerNorm). The exact-mode spec traces then assert plain decode's tokens,
and every verify slot's ops equal the decode step's bit for bit (qwen2,
bf16 and w8a8).

The MoE family (phase 4): mixtral_8x7b at full width, 8 of its 32
layers (bf16, SOLE; the launch checks of every paged trace), through
``PagedEngine``, the dense-slot ``Engine``, exact-mode oracle,
anti-oracle and n-gram spec traces beside plain, asserting plain decode's
tokens (every product of a decode or verify dispatch is row-stable,
``layers.stable_mm``), and every verify slot's ops equal to the decode
step's bit for bit, an open-loop ``AsyncEngine`` trace with cancellations
and a profiled paged wave with the expert FFN's share; dbrx_132b, 4 of 40
layers, through ``PagedEngine``; the smoke MoE engines (paged and dense,
exact and SOLE) on the card against the CPU.

The recurrent families (phases 3-5): the calibrating and the exact norm
with rwkv6's (64, 64) per-head GroupNorm affine at 512, 8,192 and
153,600 rows of 64 (bitwise against the plain version; each head's exact
rows bitwise alone), the paged kernel at recurrentgemma_9b's attention
(16 query heads on one KV head, d 256: bf16 pools on the tensor cores,
float32 on the CUDA cores), the hybrid dense path's ``_sole_probs`` and
``layers.fma`` against ``fma32``; then rwkv6_7b (32 layers) and recurrentgemma_9b (38
layers) at full width through ``PagedEngine`` (SOLE, the two-wave trace),
``PagedEngine`` in exact mode cold and then warm with a checkpoint at
every block (warm tokens equal cold; checkpoint, and for the hybrid page,
hits), the dense-slot ``Engine`` and a profiled wave (the norms' and the
recurrence's device share, the host time in the recurrence), with the
launches per forward checked (rwkv6: 3L + 1 norms; the hybrid: 2L + 1
norms and one attention launch per attention block), slot and checkpoint
bytes; the smoke engines on the card against the CPU; the new shapes
timed beside their plain versions, SDPA and ``F.group_norm``.

The encdec and vlm families (phases 3-5, ``serve_families``, each
sub-phase's ``[phase time]`` logged): ``_sole_probs`` at whisper's
encoder rows of 1,500 (all true, and with a padded tail), its
cross-attention at a decode step and a 64-row chunk (per-lane masks at
stride 0 over heads) and qwen2-vl's prefill and decode, against the plain
chain (masked entries 0); the calibrating norm bitwise and the exact
norm's rows at LayerNorm 768 and RMS 3,584; the paged kernel at 12 on 12
heads, d 64; then whisper_small at full width and depth through
``PagedEngine`` (eight requests of 1,500 frames: SOLE bf16 with the
launches per decoder forward and per encode checked, a profiled wave with
the encoder's share; exact float32 tokens equal to the dense-cache
oracle's, to a tight pool's that preempts and re-encodes and to an
``AsyncEngine`` open loop's), qwen2_vl_7b at full width and depth (2 x
1,024 embeds on a 16 x 16 patch grid and text, 32 decode steps; exact
float32 logits held to ``forward``), the smoke models card vs CPU, and
the new shapes timed.

Training (``train_phase``, each part's ``[phase time]`` logged): the
exact norm's backward kernel (``exact_norm_bwd_kernel`` +
``exact_norm_wgrad_kernel``) against autograd of its plain version at RMS
896 x 8 / 2,048 / 8,192 rows, LN 2,048, LN 768, RMS 3,584, LN 4,096 and
6,144 x 8 / 2,400 and the (64, 64) GroupNorm affine x 512 / 8,192, float32
and bf16 rows (dx within 2e-6 of its row's scale or one bf16 ulp,
dgamma/dbeta within 1e-5), bitwise on a second call and per row across
row counts; then qwen2_0_5b at full width and depth trained through the
``Trainer`` (float32 masters, bf16 compute, remat ``dots``, AdamW; 8 x
1,024 affine-task tokens, cut from train_4k's 256 x 4,096): step 0's
gradients against the reference route on the card (grad norm within
1e-3, every leaf's cosine >= 0.999), the exact norm's launches per step
(2L + 1 forward, 2L + 1 backward calls of two kernels each, 2L recomputed
by remat) and over the 20-step run, the loss falling, a checkpoint at step
10 and the resume from it bitwise equal to the uninterrupted run, step
time, tokens/s, peak
memory, the checkpoint's size and save time and one profiled step's
share of device time in the norm kernels; ``launch.train_then_serve`` at
the reference example's size (exact and SOLE copy-task accuracy and the
drop; the SOLE evaluation runs E2Softmax and the calibrating norm); a
smoke train step per config on the card against the CPU and a smoke
``Trainer`` that recovers from an induced failure; the backward kernel
timed beside autograd of its plain version and of ``F.rms_norm`` /
``F.layer_norm`` / ``F.group_norm``. The exact norm's forward is timed
at the train step's shape too (8 x 1,024 rows of 896, bf16 in and out).

The dry run, ``serve_sole`` and the sanitizers (after training, each
``[phase time]`` logged): ``launch.serve_sole`` at the example's smoke
config and at qwen2_0_5b's full width, paged and ``--dense`` (every
request its 12 tokens; tokens, tokens/s, peak pages and steps printed);
the sanitizers attached to a full-width qwen2_0_5b ``PagedEngine``,
frozen after a warm-up request, the rest of the trace under
``torch.cuda.set_sync_debug_mode("error")`` (only the engine's
sanctioned transfers sync, no kernel library or device segment after
freeze, refcount sweeps run), then an ``.item()`` injected into a step
must raise; the dry run (``launch.dryrun``, on meta tensors) against the
card: (a) qwen2_0_5b's train cell at 8 x 1,024 tokens predicts one
``Trainer`` step's ``max_memory_allocated()`` within 10% and its roofline
bound is no larger than the step's device busy time, (b) the paged decode
step at the profiled wave's shape predicts its peak within 10%, (c) both
count the product FLOPs ``FlopCounterMode`` counts on the card, and (d)
``launch.dryrun --all`` and ``--all --paged`` end with no ``error``
cell; the cells that fit one card are printed. The sweep runs on the
host's CPU, one process per (arch, dense or paged), into
``build/dryrun_sweep``: its longest jobs on three cores while the kernels
build (five ``nvcc`` processes on the machine's eight cores; the jobs
started then are waited for after the kernel checks), the rest on every
core after the last timed phase (the profiled waves), so no timed phase
shares the host with it. The profiled
waves read the profiler's raw events (``device_rows``), not
``key_averages()``.

Tensor-parallel serving (``mesh_serve``, after the dry run's checks, its
``[phase time]`` logged): the paged kernel at the per-rank shapes of the
mesh plans (qwen2_0_5b's 7 q heads on 1 KV head at M = 2; its
replicated-KV maps at M = 7, every rank, rank 3's group straddling two KV
heads and the other ranks leaving a pool head unread; minitron_8b at M =
2 and 4; recurrentgemma_9b's 8 heads on its one replicated KV head) at
decode and a 128-row chunk, bf16 and int8 + ``quant_pv`` pools, SOLE and
exact, bitwise the single card's launch on the same heads and within the
card tests' bar of the plain version, and the int8 GEMM at qwen2_0_5b's
and minitron_8b's N / 2 and K / 2 shapes bitwise; qwen2_0_5b's bf16
products in their tensor-parallel forms (column-parallel slices bitwise
the single card's columns, row-parallel float32 partial sums within a
rounding step of the single card's product, the share apart printed);
then qwen2_0_5b at full width and depth (ten greedy requests of at most
64 prompt tokens, 8 new tokens, decode horizon 2) on one card and on a
(1, 2) mesh whose two ranks (``launch.mesh.spawn``) share the card over
gloo, each engine built from host-memory weights after the peak is reset:
exact float32 (tokens equal, or the first divergence inside a top-2
margin no larger than the first forward's measured logit difference),
then the n-gram drafter on the same requests (every rank's tokens its
plain decode's), SOLE bf16 (agreement share printed), W8A8 + int8 KV
(tokens and the first and last logits bitwise); and SOLE bf16 on a (1, 4)
mesh (attention replicated; the first four requests, beside the single
card on the same four). Every rank's tokens are equal; collectives a
forward (2L + 2; 4L + 2 at W8A8; L + 2 at (1, 4)), the collectives' host
share of the wall, parameter, pool and peak bytes a rank are checked or
printed, and where each spawn's wall went. Where the machine shows two
cards or more, the (1, 2) exact trace runs again over nccl, one card a
rank, under the sanitizers' sync guard; with one card the phase says nccl
did not run.

Prints the kernel table as one JSON line, the ``nvidia-smi`` line, and
last ``{"ok": true, "device": {...}}``. Exits non-zero without a result
when no CUDA device is available or the port is not beside this file.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import os
import shutil
import subprocess
import sys
import threading
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
# operand types of repro_torch.roofline.analysis.PEAK_FLOPS, the one source
# of the H100's peaks (and its HBM rate) every bound here takes
BF16, FP32, INT8 = "bfloat16", "float32", "int8"
QNORM_OPS_PER_ELEMENT = 16         # as repro_torch.roofline.cost counts them
E2_OPS_PER_ELEMENT = 16
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
    """(bytes, flops) the paged attention must move / do on these inputs
    (``repro_torch.roofline.cost.paged_attention_work``, which the dry
    run counts the kernel with): q, the live keys' K and V rows and the
    fp32 output once; 4*d flops per unmasked (query, key) pair and head."""
    from repro_torch.roofline.cost import paged_attention_work
    q, k, _, _, meta = case
    return paged_attention_work(tuple(q.shape), q.element_size(),
                                k.element_size(), meta.tolist(),
                                causal=causal, kv_heads=kvh)


def bound_ms(nbytes, flops, kind):
    """(least ms, "bytes" or "operations") of ``nbytes`` moved and
    ``flops`` operations of type ``kind`` on the H100
    (``repro_torch.roofline.analysis.bound_s``)."""
    from repro_torch.roofline.analysis import bound_s
    t, by = bound_s(nbytes, {kind: flops})
    return t * 1e3, by


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
    """Mean device time of one launch of the kernel whose name holds
    ``kernel`` (``fn`` launches it once a call, L2 flushed before each),
    from ``torch.profiler``'s CUDA activity: the kernel alone, without
    launch or event overhead. The mean is over the launches the profiler
    recorded, which in a short window can be fewer than ``reps`` (it kept
    1 of 20 once). None when it records no device time for it."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush()
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if kernel in e.key]
    us = sum(_device_us(e) for e in rows)
    return us / sum(e.count for e in rows) / 1e3 if us > 0 else None


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


def device_rows(torch, prof):
    """(device us, count, name) of each device-side name (kernels, copies,
    sets) the profiler recorded, largest first: the sums ``key_averages()``
    gives, read from the raw events without building its event tree,
    which takes tens of seconds over a wave's ~100k kernels."""
    cuda = torch.autograd.DeviceType.CUDA
    acc = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            us, n = acc.get(e.name(), (0.0, 0))
            acc[e.name()] = (us + e.duration_ns() / 1e3, n + 1)
    return sorted(((us, n, name) for name, (us, n) in acc.items() if us > 0),
                  reverse=True)


def _device_us(event) -> float:
    for attr in ("device_time_total", "cuda_time_total"):
        if hasattr(event, attr):
            return float(getattr(event, attr))
    return 0.0


def sass_mma_counts(build):
    """Tensor-core instructions in the built kernels' SASS (``cuobjdump
    -sass``): per kernel function of the dense flash library, its
    ``HMMA...BF16`` count, and of the int8 GEMM library, its
    ``IMMA...S8`` count; of the paged library, each kernel's ``HMMA``
    count; None where the toolkit has no cuobjdump."""
    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    if not os.path.exists(tool):
        return None
    counts = {}
    for lib, kind, op in (("flash_e2softmax", "flash_e2softmax_", "HMMA"),
                          ("paged_e2softmax", "paged_e2softmax_", "HMMA"),
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
# a speculative verify dispatch's rows (8 lanes x C = 5) at qwen2_0_5b's
# width and at minitron_8b's
CALIB_CASES.update({"verify": (DECODE_BATCH * 5, 896, True),
                    "ln4096_verify": (DECODE_BATCH * 5, 4096, False)})
# RMS at mixtral_8x7b's 4,096 channels (dbrx_132b's LayerNorm at 6,144 is
# nemotron_4_15b's, above)
CALIB_CASES.update({f"rms4096_{name}": (rows, 4096, True)
                    for name, rows in (("decode", DECODE_BATCH),
                                       ("prefill", PREFILL_CHUNK),
                                       ("dense_prefill", DECODE_BATCH * 300))})


# (rows, C, rms) on each side of the calibrating norm's plan boundaries
# (kernels.ailayernorm.calib_plan): the decode cluster's 16 CTAs, the
# route at 128 rows and the grid's one CTA an SM; checked, not timed
CALIB_BOUNDARY_CASES = {f"boundary_{rows}x{c}": (rows, c, rows % 2 == 0)
                        for rows, c in ((16, 6144), (17, 6144), (127, 896),
                                        (129, 896), (127, 6144), (129, 6144),
                                        (132, 896), (133, 896))}


def check_calib_norm(torch):
    """Phase 3, the calibrating norm: residual add, PTF calibration over
    all rows and quantize+norm in one launch (a cluster for decode rows, a
    cooperative grid for prefill rows), against the torch chain it
    replaces (its plain version) on bf16 activations: ``h``, ``alpha``,
    ``scale``, the bf16 output and the quantize-out codes and row scales
    bitwise, on two calls in a row, at the timed cases and the plan's
    boundary rows; each case logs its route."""
    from repro_torch.kernels import ailayernorm as KN
    gen = torch.Generator(device="cuda").manual_seed(3)
    res = {}
    for name, (rows, c, rms) in {**CALIB_CASES,
                                 **CALIB_BOUNDARY_CASES}.items():
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
        if name in CALIB_CASES:
            res[name] = dict(x=x, r=r, gamma=gamma, beta=beta, rms=rms,
                             max_abs_err=0.0)
        plan = KN.calib_plan(rows, c, x.element_size())
        log(f"ailayernorm_calib {name} rows={rows} C={c} "
            f"{'rms' if rms else 'ln'} [{plan.route}, {plan.ctas} CTAs of "
            f"{plan.chunk} rows, {plan.keep} kept, {plan.teams} teams]: h, "
            f"alpha, scale, bf16 out, int8 "
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
    # a speculative verify dispatch's rows: 8 lanes x C = 5
    shapes += [(f"{nm}_m{DECODE_BATCH * 5}", DECODE_BATCH * 5, k, n)
               for nm, k, n in GEMM_KN]
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
        # the profiler can drop every record of a kernel launched through
        # ctypes in a window (it kept 0 of 5 once): up to three windows
        for _ in range(3):
            n, others, seen = device_kernels(
                torch, lambda: L._sole_probs(logits, mask, cfg,
                                             torch.bfloat16))
            if seen:
                break
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
            "ailayernorm_calib": KN.calibrated_norm,
            "ailayernorm_exact": KN.exact_norm,
            "ailayernorm_exact_bwd": KN.exact_norm_backward}


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
    norms = (2 * cfg.n_layers + 1) * calls
    exact_norms = cfg.norm_mode == "exact"
    want_launches = {"e2softmax": cfg.n_layers * calls,
                     "ailayernorm_calib": 0 if exact_norms else norms,
                     "ailayernorm_exact": norms if exact_norms else 0,
                     "ailayernorm_exact_bwd": 0, "ailayernorm_qnorm": 0,
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
        bms, by = bound_ms(nbytes, flops, BF16)
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
    dt = q.dtype

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
                           FP32)
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
    its stride-0 dims once), as the dry run counts a mask's reads."""
    from repro_torch.roofline.cost import distinct_bytes as count
    return count(t)


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
        bms, by = bound_ms(nbytes, E2_OPS_PER_ELEMENT * x.numel(), FP32)
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
                           FP32)
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
        bms, by = bound_ms(nbytes, flops, BF16)
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
        bms, by = bound_ms(nbytes, 2 * m * k * n, INT8)
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
        bms, by = bound_ms(nbytes, flops, BF16)
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
                               * rows * c, FP32)

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
    bms, by = bound_ms(nbytes, QNORM_OPS_PER_ELEMENT * rows * c, FP32)
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
                           FP32)
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
    rows = device_rows(torch, prof)
    busy = sum(r[0] for r in rows) / 1e6
    # forwards: one attention launch per layer (the paged kernel, or the
    # dense engine's E2Softmax); kernels per forward: every device kernel
    kernels = sum(n for _, n, _ in rows)
    attn = sum(n for _, n, key in rows
               if (is_dense_e2(key) if dense else "paged_e2softmax" in key))
    forwards = attn / cfg.n_layers
    per_fwd = kernels / forwards if forwards else float("nan")
    attn_ms = sum(us for us, _, key in rows
                  if (is_dense_e2(key) if dense else "paged_e2softmax" in key)
                  ) / 1e3
    log(f"[{label}] profiled wave: wall {wall:.3f} s, device busy "
        f"{busy:.3f} s ({busy / wall:.3f} of wall), "
        f"{len(reqs) * NEW_TOKENS} new tokens, {kernels} kernels over "
        f"{forwards:.0f} forwards ({per_fwd:.1f} per forward); attention "
        f"kernel {attn_ms:.2f} ms")
    for us, n, key in rows[:12]:
        log(f"  {us / 1e3:9.2f} ms {n:7d} x  {key[:100]}")
    return {"wall_s": wall, "device_busy_s": busy, "kernels": kernels,
            "forwards": forwards, "kernels_per_forward": per_fwd,
            "attention_kernel_ms": attn_ms,
            "top": [{"ms": us / 1e3, "count": n, "kernel": key[:100]}
                    for us, n, key in rows[:12]]}


# -- the relu2 + LayerNorm configs (minitron_8b, nemotron_4_15b) -------------


def check_paged_d128(torch, cfg):
    """Phase 3 at minitron_8b's attention (head dim 128, 32 heads over 8
    KV heads): the paged kernel (the tensor cores: ``d^-1/2 = 2^-3.5`` is
    no power of two, so q is scaled in float32 and split into three bf16
    parts) against its plain version at the decode and prefill-chunk
    shapes, over bf16 pools and int8 pools (``quant_pv`` on and off). The
    kernel's products are exact but summed in another order than the
    plain float32 einsum, so exact mode is held to 1e-4 of the output
    scale and a SOLE output, whose codes can flip at a tie, to at most 1%
    of rows off by more than 1e-3. Each case logs the route it took.
    Returns (bf16 results, int8 results) keyed
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
            if not variant.startswith("bf16 mma"):
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
                route=variant,
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
    paged wave, the exact-mode oracle, anti-oracle and n-gram spec traces
    (plain decode's tokens) and the op-by-op verify/decode probe; then at
    w8a8
    with int8 KV pages; then nemotron_4_15b
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
    spec = spec_traces(torch, mini, params, "minitron bf16")
    spec["ops"] = verify_decode_ops(torch, mini, params, "minitron bf16")
    if not spec["ops"]["all_slots_bitwise"]:
        raise AssertionError("minitron exact: a verify slot parts from its "
                             "decode step")
    trace["spec"] = spec
    out["minitron_spec_oracle"] = (spec["oracle"]["launches"], {})
    out["minitron_spec_ngram"] = (spec["ngram"]["launches"], {})
    out["minitron_spec_anti_oracle"] = (spec["anti-oracle"]["launches"],
                                        {})
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


# -- speculative decoding, the streaming loop, cancellation -------------------

VERIFY_K = 4                       # the spec traces' max_k: C = K + 1 = 5
VERIFY_CS = (2, 3, 5, 9)           # verify widths checked (K 1, 2, 4, 8)
VERIFY_ROWS = DECODE_BATCH * (VERIFY_K + 1)   # 40 rows per verify dispatch
VERIFY_Q_START = (48, 299, 117, 0, 255, 83, 160, 0)
SPEC_NEW_TOKENS = 16               # the draft-model pair's budget
OPEN_LOOP_RATE = 0.5               # requests per engine step


def verify_lanes(c):
    """Per-lane (q_start, kv_len) of a verify batch of ``DECODE_BATCH``
    lanes at width ``c``: ragged n_valid (c, c - 1, 1, c // 2 ...; rows
    past it attend every valid key) and two null lanes (q_start 0, kv_len
    1, page 0)."""
    n_valid = (c, max(1, c - 1), 1, 1, c, max(1, c // 2), c, 1)
    kv = [q + n for q, n in zip(VERIFY_Q_START, n_valid)]
    return list(VERIFY_Q_START), kv


def check_verify_kernels(torch, cfg, mini):
    """Phase 3 at the verify dispatch's shapes: the paged kernel at
    ``DECODE_BATCH`` lanes x C in ``VERIFY_CS`` rows, causal, a q_start
    per lane, n_valid < C and null lanes, against its plain version. At
    qwen2_0_5b's attention (tensor cores) on bf16 pools: exact-logit
    inputs to 1e-5 of the output scale in SOLE and exact mode, random ones
    with at most 1% of rows off by more than 1e-3 (SOLE); on int8 pools
    with ``quant_pv``, exact-logit inputs to 1e-5. At minitron_8b's head
    dim 128 (tensor cores, q scaled in float32: 2^-3.5 is no exact bf16
    factor) on bf16 and int8 pools: exact mode to 1e-4 of the output
    scale, SOLE at most 1% of rows off by more than 1e-3. Returns
    the C = K + 1 cases for the timings: (bf16 results, int8 results)."""
    from repro_torch.kernels import flash_e2softmax as KA
    from repro_torch.models.layers import KV_INT8_SCALE, LOGIT_INT8_SCALE
    gen = torch.Generator(device="cuda").manual_seed(20)
    out16, out8 = {}, {}
    for model, name in ((cfg, "verify"), (mini, "minitron_verify")):
        h, kvh, d = model.n_heads, model.n_kv_heads, model.head_dim
        kvmap = KA.default_kv_head_map(h, kvh, "cuda")
        wide = d != 64                      # q scaled in float32: wider bars
        # (int8 pools, exact-logit grid) of each case
        combos = (((False, False), (True, False)) if wide else
                  ((False, True), (False, False), (True, True)))
        for c in VERIFY_CS:
            q_start, kv = verify_lanes(c)
            errs, offs, cases = {}, {}, {}
            for int8, grid in combos:
                case = paged_case(torch, gen, b=DECODE_BATCH, c=c,
                                  q_start=q_start, kv_lens=kv, h=h, kvh=kvh,
                                  d=d, grid=grid, int8=int8)
                cases[int8] = case
                for mode in ("sole", "exact"):
                    kw = dict(sole=mode == "sole", exp_bits=cfg.exp_bits,
                              int8_scale=(LOGIT_INT8_SCALE if mode == "sole"
                                          else None))
                    if int8:
                        kw.update(kv_scale=KV_INT8_SCALE, quant_pv=True)
                    out = KA.flash_e2softmax_paged(*case, causal=True, **kw)
                    ref = KA.flash_e2softmax_paged_plain(
                        *case, kvmap, causal=True, **kw)
                    torch.cuda.synchronize()
                    if not torch.isfinite(out).all():
                        raise AssertionError(f"paged {name} C={c}: "
                                             "non-finite")
                    err = (out - ref).abs()
                    scale = max(ref.abs().max().item(), 1.0)
                    key = (f"{'int8' if int8 else 'bf16'}_"
                           f"{'grid' if grid else 'random'}_{mode}")
                    errs[key] = err.max().item()
                    if grid or (wide and mode == "exact"):
                        tol = (1e-4 if wide else 1e-5) * scale
                        if errs[key] > tol:
                            raise AssertionError(
                                f"paged {name} C={c} {key}: max |err| "
                                f"{errs[key]} > {tol}")
                    elif mode == "sole":
                        offs[key] = (err.amax(-1) > 1e-3 * scale).float(
                            ).mean().item()
                        if offs[key] > 0.01:
                            raise AssertionError(
                                f"paged {name} C={c} {key}: {offs[key]} of "
                                "rows off by > 1e-3")
            variant = KA.paged_variant(torch.bfloat16, torch.bfloat16, d,
                                       BLOCK_SIZE)
            log(f"paged_e2softmax {name} B={DECODE_BATCH} C={c} H {h}/KV "
                f"{kvh} d {d} [{variant}] q_start {q_start} kv_len {kv}: "
                "max|err| " + ", ".join(f"{k} {v:.3e}"
                                        for k, v in errs.items())
                + "; SOLE rows off by > 1e-3: " + ", ".join(
                    f"{k} {v:.5f}" for k, v in offs.items()))
            if c != VERIFY_K + 1:
                continue
            held = [v for k, v in errs.items() if k.startswith("bf16") and
                    ("grid" in k or wide)]
            out16[name] = dict(case=cases[False], causal=True,
                               max_abs_err=max(held),
                               max_abs_err_random=max(
                                   v for k, v in errs.items()
                                   if k.startswith("bf16_random")))
            out8[name] = dict(case=cases[True], causal=True,
                              max_abs_err=max(v for k, v in errs.items()
                                              if k.startswith("int8")))
    return out16, out8


def compare_verify_decode_routes(torch, cfg):
    """Phase 3, the record of the split the verify route no longer takes
    (prefill chunks still do): the paged kernel's C > 1 route (one causal
    call over the verify rows; the tensor-core kernel at qwen2_0_5b's head
    dim) against
    its C = 1 route (the decode kernel, pages split over warps; one call
    per slot at kv_len = position + 1) for the same query rows, pools and
    pages, in exact and SOLE mode over bf16 and int8 pages, on exact-logit
    and random inputs. Prints the share of rows that are bitwise equal and
    the largest difference; holds them to the plain version's bar (1e-5
    of the output scale on exact-logit inputs). Returns the summary."""
    from repro_torch.kernels import flash_e2softmax as KA
    from repro_torch.models.layers import KV_INT8_SCALE, LOGIT_INT8_SCALE
    gen = torch.Generator(device="cuda").manual_seed(21)
    h, kvh, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    summary = {}
    for c in (VERIFY_K + 1, 9):
        q_start, kv = verify_lanes(c)
        n_valid = [k - q for k, q in zip(kv, q_start)]
        live = [i for i, q in enumerate(q_start) if q > 0]
        for int8 in (False, True):
            for grid in (True, False):
                case = paged_case(torch, gen, b=DECODE_BATCH, c=c,
                                  q_start=q_start, kv_lens=kv, h=h, kvh=kvh,
                                  d=d, grid=grid, int8=int8)
                q, pk, pv, tables, meta = case
                for mode in ("exact", "sole"):
                    kw = dict(sole=mode == "sole", exp_bits=cfg.exp_bits,
                              int8_scale=(LOGIT_INT8_SCALE if mode == "sole"
                                          else None))
                    if int8:
                        kw.update(kv_scale=KV_INT8_SCALE, quant_pv=True)
                    wide = KA.flash_e2softmax_paged(*case, causal=True, **kw)
                    same = total = 0
                    worst = 0.0
                    for i in range(c):
                        m = meta.clone()
                        m[:, 0] += i
                        m[:, 1] = m[:, 0] + 1
                        narrow = KA.flash_e2softmax_paged(
                            q[:, :, i:i + 1].contiguous(), pk, pv, tables, m,
                            causal=False, **kw)
                        for lane in live:
                            if i >= n_valid[lane]:
                                continue
                            a = wide[lane, :, i]
                            b_ = narrow[lane, :, 0]
                            same += int((a == b_).all(-1).sum())
                            total += a.shape[0]
                            worst = max(worst, (a - b_).abs().max().item())
                    torch.cuda.synchronize()
                    scale = max(wide.abs().max().item(), 1.0)
                    key = (f"C{c}_{'int8' if int8 else 'bf16'}_"
                           f"{'grid' if grid else 'random'}_{mode}")
                    summary[key] = dict(rows=total, bitwise_rows=same,
                                        bitwise_share=same / total,
                                        max_abs_diff=worst)
                    if grid and worst > 1e-5 * scale:
                        raise AssertionError(
                            f"verify vs decode route {key}: max |diff| "
                            f"{worst} > {1e-5 * scale}")
    for key, v in summary.items():
        log(f"paged route C>1 vs C=1 {key}: {v['bitwise_rows']}/{v['rows']} "
            f"rows bitwise equal ({v['bitwise_share']:.4f}), max |diff| "
            f"{v['max_abs_diff']:.3e}")
    return summary


def trace_requests(cfg, new_tokens=NEW_TOKENS):
    """The trace's ten prompts as one closed batch: wave 1's eight, a
    repeat of request 0 (a prefix hit) and the second system-prompt
    request, greedy, ``new_tokens`` each."""
    from repro_torch.serve.engine import Request
    prompts, tail = trace_prompts(cfg)
    return [Request(prompt=p, max_new_tokens=new_tokens)
            for p in prompts + [prompts[0], tail]]


class OracleDrafter:
    """Proposes a plain run's tokens (by sequence id): all accepted while
    the spec run follows the plain one."""

    def __init__(self, outs):
        self.outs = outs

    def propose(self, lanes, ks):
        return [self.outs[s.seq_id][len(s.out):len(s.out) + k]
                for s, k in zip(lanes, ks)]


class AntiOracleDrafter(OracleDrafter):
    """The plain run's next tokens shifted by one: all rejected."""

    def __init__(self, outs, vocab_size):
        super().__init__(outs)
        self.vocab_size = vocab_size

    def propose(self, lanes, ks):
        return [[(t + 1) % self.vocab_size for t in d]
                for d in super().propose(lanes, ks)]


class RowRecorder:
    """Records the logits row of every live lane of a paged engine's
    decode steps and verify dispatches (the same model calls the engine
    makes), keyed by (sequence id, position of the fed token): with
    ``against=None`` it keeps the rows on the device; otherwise it keeps,
    per key present there, the largest |difference| from that row and
    which dispatch made it (the last one at a key wins: it saw the kept
    prefix)."""

    def __init__(self, torch, eng, against=None):
        from repro_torch.models import transformer as T
        self.torch, self.eng, self.T = torch, eng, T
        self.against, self.rows, self.lanes = against, {}, []
        self.vocab = eng.cfg.vocab_size

    def _keep(self, seq, pos, row, source):
        key = (seq.seq_id, pos)
        row = row[:self.vocab].float()
        if self.against is None:
            self.rows[key] = row.clone()
        elif key in self.against:
            diff = (row - self.against[key]).abs().max().item()
            self.rows[key] = (diff, source, int(row.argmax()))

    def __enter__(self):
        T, eng = self.T, self.eng
        self.orig = (T.decode_step_paged, T.prefill_paged, eng._refs)

        def refs(seqs):
            self.lanes = list(seqs)
            return self.orig[2](seqs)

        def decode(params, pools, token, pos, tables, cfg, **kw):
            logits, pools = self.orig[0](params, pools, token, pos, tables,
                                         cfg, **kw)
            for i, p in enumerate(pos.tolist()):
                if self.lanes[i] is not None:
                    self._keep(self.lanes[i], p, logits[i], "decode")
            return logits, pools

        def prefill(params, tokens, q_start, n_valid, tables, pools, cfg,
                    **kw):
            logits, pools = self.orig[1](params, tokens, q_start, n_valid,
                                         tables, pools, cfg, **kw)
            if tokens.shape[0] == eng.decode_batch and tokens.shape[1] > 1:
                for i, (q0, n) in enumerate(zip(q_start.tolist(),
                                                n_valid.tolist())):
                    if self.lanes[i] is None:
                        continue
                    for j in range(n):
                        self._keep(self.lanes[i], q0 + j, logits[i, j],
                                   "verify")
            return logits, pools

        T.decode_step_paged, T.prefill_paged = decode, prefill
        eng._refs = refs
        return self

    def __exit__(self, *exc):
        self.T.decode_step_paged, self.T.prefill_paged = self.orig[:2]
        del self.eng._refs


def spec_engine(cfg, params, spec=None, blocks=None):
    from repro_torch.serve.engine import PagedEngine
    return PagedEngine(cfg, params,
                       num_blocks=blocks or 8 * MAX_SEQ_LEN // BLOCK_SIZE + 1,
                       block_size=BLOCK_SIZE, max_seq_len=MAX_SEQ_LEN,
                       max_running=8, decode_batch=DECODE_BATCH,
                       prefill_chunk=PREFILL_CHUNK, decode_horizon=8,
                       device="cuda", spec_config=spec)


def run_spec_trace(torch, cfg, params, reqs, drafter=None, *,
                   max_k=VERIFY_K, record=None):
    """One closed batch through ``PagedEngine`` (speculative when
    ``drafter`` is given): launch counts set to 0 just before and read
    just after, the launches of each verify dispatch, the drafter's host
    time and the wall. ``record``: None, or the plain run's rows to hold
    the verify rows against (``{}`` records a plain run's rows)."""
    from repro_torch.models import api
    from repro_torch.serve.spec import SpecConfig
    spec = None if drafter is None else SpecConfig(drafter, max_k=max_k)
    eng = spec_engine(cfg, params, spec)
    wrappers = kernel_wrappers()
    per_verify, draft_s = [], [0.0]
    real_verify = api.verify_paged

    def counted(*a, **kw):
        before = read_launches()
        out = real_verify(*a, **kw)
        after = read_launches()
        per_verify.append({k: after[k] - before[k] for k in wrappers})
        return out
    if drafter is not None:
        real_propose = drafter.propose

        def timed(lanes, ks):
            t0 = time.perf_counter()
            out = real_propose(lanes, ks)
            draft_s[0] += time.perf_counter() - t0
            return out
        drafter.propose = timed
    api.verify_paged = counted
    rec = None
    try:
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if record is None:
            outs = eng.generate(reqs)
        else:
            with RowRecorder(torch, eng, against=record or None) as rec:
                outs = eng.generate(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
    finally:
        api.verify_paged = real_verify
        if drafter is not None:
            drafter.propose = real_propose
    eng.cache.check_refcounts()
    stats = eng.stats()
    if stats["blocks_in_use"]:
        raise AssertionError(f"{stats['blocks_in_use']} pages in use after "
                             "the trace")
    return dict(outs=outs, stats=stats, wall_s=wall, launches=launches,
                per_verify=per_verify, draft_host_s=draft_s[0],
                rows=None if rec is None else rec.rows)


def first_divergence(a, b):
    return next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)


def divergence_report(torch, reqs, plain, spec_outs, plain_rows, rows):
    """Each request's first token where a spec run leaves the plain run,
    with the plain decode row's top-2 margin there and the largest
    |difference| of the spec run's row at that position (verify or
    decode) from it, both from recorded replays (``RowRecorder``)."""
    out = {}
    for i, (p, s) in enumerate(zip(plain, spec_outs)):
        j = first_divergence(p, s)
        if j is None:
            continue
        key = (i, len(reqs[i].prompt) + j - 1)
        margin, diff = None, rows.get(key)
        if key in plain_rows:
            top = torch.topk(plain_rows[key], 2).values
            margin = (top[0] - top[1]).item()
        out[i] = dict(token=j, plain=p[j], spec=s[j],
                      plain_top2_margin=margin,
                      spec_vs_plain_max_abs_logit_diff=(
                          None if diff is None else diff[0]),
                      spec_row_from=None if diff is None else diff[1])
    return out


def prefix_row_diffs(plain, spec_outs, reqs, rows):
    """Over every recorded spec-run row whose fed prefix equals the plain
    run's (positions up to each request's first divergence): rows, rows
    bitwise equal to the plain decode row, the largest |difference|, by
    dispatch kind."""
    res = {}
    for (sid, pos), (diff, src, _) in rows.items():
        j = pos + 1 - len(reqs[sid].prompt)
        first = first_divergence(plain[sid], spec_outs[sid])
        if first is not None and j > first:
            continue
        r = res.setdefault(src, dict(rows=0, bitwise=0, max_abs_diff=0.0))
        r["rows"] += 1
        r["bitwise"] += int(diff == 0.0)
        r["max_abs_diff"] = max(r["max_abs_diff"], diff)
    return res


def check_per_verify(label, per_verify, cfg, sole, w8a8):
    """Each verify dispatch launches the paged attention once per layer,
    the calibrating norm 2L + 1 times in SOLE mode (in exact mode the
    row-stable exact norm as often), the int8 GEMM once per projection
    and the head at w8a8, and no static-params norm."""
    want = {"paged_e2softmax": cfg.n_layers,
            "ailayernorm_calib": 2 * cfg.n_layers + 1 if sole else 0,
            "ailayernorm_exact": 0 if sole else 2 * cfg.n_layers + 1,
            "int8_matmul": gemm_per_forward(cfg) if w8a8 else 0,
            "ailayernorm_qnorm": 0}
    for n, got in enumerate(per_verify):
        if any(got[k] != v for k, v in want.items()):
            raise AssertionError(f"[{label}] verify dispatch {n}: launches "
                                 f"{got}, expected {want}")
    return want


def spec_summary(label, run, plain_wall=None):
    st = run["stats"]
    keys = ("spec_dispatches", "spec_proposed_tokens", "spec_accepted_tokens",
            "spec_fallback_steps", "acceptance_rate",
            "accepted_tokens_per_target_dispatch", "decode_dispatches",
            "decode_tokens", "steps", "truncated_tokens", "reclaimed_pages")
    out = {k: st[k] for k in keys if k in st}
    out.update(wall_s=run["wall_s"], draft_host_s=run["draft_host_s"],
               verify_dispatches=len(run["per_verify"]))
    log(f"[{label}] wall {run['wall_s']:.3f} s"
        + ("" if plain_wall is None else
           f" (plain {plain_wall:.3f} s in this call)")
        + f", drafter host {run['draft_host_s']:.3f} s; "
        + json.dumps({k: v for k, v in out.items()
                      if k not in ("wall_s", "draft_host_s")}))
    return out


def spec_traces(torch, cfg, params, label):
    """Phase 4: the ten trace requests, ``NEW_TOKENS`` each, through
    ``PagedEngine`` with speculative decoding (``max_k`` 4, decode batch
    8), beside the plain run in the same call, in exact mode. bf16: an
    oracle drafter (the plain run's tokens), an anti-oracle (acceptance 0
    and the controller back on the horizon) and the n-gram drafter; at
    w8a8 (int8 pages) the oracle and n-gram. Every request's tokens equal
    the plain run's: verify rows are decode rows bit for bit (the paged
    kernel's decode route, the row-stable exact norm and the row-stable
    products of decode and verify dispatches); a divergence fails with
    its first token, the plain run's top-2 margin and the |logit
    difference| there (recorded replays). The oracle's rows are recorded
    and compared with the plain run's decode rows. Each verify dispatch's
    launches are checked."""
    from repro_torch.serve.spec import NGramDrafter
    cfg = dataclasses.replace(cfg, softmax_mode="exact", norm_mode="exact",
                              logit_int8=False)
    w8a8 = cfg.quant.acts
    reqs = trace_requests(cfg)
    plain = run_spec_trace(torch, cfg, params, reqs)
    outs = plain["outs"]
    if any(len(o) != NEW_TOKENS for o in outs):
        raise AssertionError(f"[{label}] plain trace token counts")
    log(f"[{label} exact plain] wall {plain['wall_s']:.3f} s, "
        f"{plain['stats']['decode_dispatches']} decode dispatches, "
        f"{plain['stats']['tokens_per_dispatch']} tokens per dispatch")
    oracle = {i: list(o) for i, o in enumerate(outs)}
    drafters = {"oracle": lambda: OracleDrafter(oracle),
                "ngram": NGramDrafter}
    if not w8a8:
        drafters["anti-oracle"] = lambda: AntiOracleDrafter(
            oracle, cfg.vocab_size)
    plain_rec = None
    res = {"plain_wall_s": plain["wall_s"],
           "plain_stats": {k: plain["stats"][k] for k in (
               "decode_dispatches", "decode_tokens", "steps",
               "tokens_per_dispatch")}}
    for name, make in drafters.items():
        run = run_spec_trace(torch, cfg, params, reqs, make())
        tag = f"{label} exact {name}"
        if any(len(o) != NEW_TOKENS for o in run["outs"]):
            raise AssertionError(f"[{tag}] token counts")
        if not run["per_verify"] and name != "ngram":
            raise AssertionError(f"[{tag}] no verify dispatch")
        want = check_per_verify(tag, run["per_verify"], cfg, False, w8a8)
        summ = spec_summary(tag, run, plain["wall_s"])
        summ["launches_per_verify"] = want
        summ["launches"] = run["launches"]
        st = run["stats"]
        if name == "anti-oracle" and (st["spec_accepted_tokens"]
                                      or not st["spec_fallback_steps"]):
            raise AssertionError(f"[{tag}] accepted "
                                 f"{st['spec_accepted_tokens']}, fallback "
                                 f"steps {st['spec_fallback_steps']}")
        diverged = run["outs"] != outs
        divs, replay_same = {}, None
        if diverged or name == "oracle":
            # recorded replays: the traces are deterministic, so the
            # replays' rows are the runs' (their tokens are checked)
            if plain_rec is None:
                plain_rec = run_spec_trace(torch, cfg, params, reqs,
                                           record={})
            rec = run_spec_trace(torch, cfg, params, reqs, make(),
                                 record=plain_rec["rows"])
            replay_same = (plain_rec["outs"] == outs
                           and rec["outs"] == run["outs"])
            divs = divergence_report(torch, reqs, outs, run["outs"],
                                     plain_rec["rows"], rec["rows"])
            summ["verify_vs_decode_rows"] = prefix_row_diffs(
                outs, rec["outs"], reqs, rec["rows"])
            log(f"[{tag}] logits rows against the plain run's decode rows "
                "at the same positions and prefixes: "
                + json.dumps(summ["verify_vs_decode_rows"]))
        if diverged:
            raise AssertionError(f"[{tag}] differs from plain decode "
                                 f"(replays reproduce the runs: "
                                 f"{replay_same}): {divs}")
        summ["replays_reproduce_runs"] = replay_same
        log(f"[{tag}] requests equal to the plain run: "
            f"{sum(o == p for o, p in zip(run['outs'], outs))}/{len(outs)}")
        res[name] = summ
    return res


# the model-layer functions a paged forward calls, in its order
FORWARD_OPS = ("apply_norm", "quantize_act", "qmatmul", "_project_qkv",
               "apply_rope", "kv_quant", "paged_attend", "_wo_proj",
               "apply_residual_norm", "apply_mlp", "lm_logits")


class OpRecorder:
    """Records the output of every ``FORWARD_OPS`` call of the model layer
    (``repro_torch.models.layers``) and of the MoE FFN
    (``repro_torch.models.moe.apply_moe_ffn``), in call order."""

    def __init__(self):
        from repro_torch.models import layers as L
        from repro_torch.models import moe as M
        self.calls = []
        self.orig = [(L, n, getattr(L, n)) for n in FORWARD_OPS]
        self.orig.append((M, "apply_moe_ffn", M.apply_moe_ffn))

    def __enter__(self):
        def wrap(name, fn):
            def recorded(*a, **kw):
                out = fn(*a, **kw)
                self.calls.append((name, out))
                return out
            return recorded
        for mod, n, fn in self.orig:
            setattr(mod, n, wrap(n, fn))
        return self

    def __exit__(self, *exc):
        for mod, n, fn in self.orig:
            setattr(mod, n, fn)


def _lane0_rows(torch, out, b, c, slot):
    """Lane 0's row at ``slot`` of each tensor in a recorded output, nested
    tuples included ((B, C, ...) or (B * C, ...) rows)."""
    if isinstance(out, tuple):
        return [r for t in out for r in _lane0_rows(torch, t, b, c, slot)]
    if not torch.is_tensor(out) or out.ndim == 0:
        return []
    if out.ndim >= 2 and out.shape[0] == b and out.shape[1] == c:
        return [out[0, slot].float()]
    if out.shape[0] == b * c:
        return [out[slot].float()]
    return []


def verify_decode_ops(torch, cfg, params, label):
    """Where a verify slot and the decode step at the same position and
    prefix first part, op by op: one request's state after a few decode
    steps; five decode steps from position p (8 lanes, 7 null, as the
    engine pads them) against one ``verify_paged`` dispatch of the same
    five fed tokens (8 lanes x C 5) on a copy of the same pools, every
    model-layer op (and the MoE FFN) recorded; for each slot, the first op
    (and layer) whose output row differs, its largest |difference|, and
    the logits' (exact mode)."""
    from repro_torch.models import api
    from repro_torch.serve.engine import Request
    cfg = dataclasses.replace(cfg, softmax_mode="exact", norm_mode="exact",
                              logit_int8=False)
    eng = spec_engine(cfg, params)
    prompts, _ = trace_prompts(cfg)
    seq = eng.submit(Request(prompt=prompts[0], max_new_tokens=NEW_TOKENS))
    while len(seq.out) < 3:
        eng.step()
    c = VERIFY_K + 1
    pos = seq.prompt_len + len(seq.out) - 1
    eng._apply_copies(eng.sched.ensure_tokens(seq, pos, pos + c))
    refs = eng._refs([seq] + [None] * (DECODE_BATCH - 1))
    pools0 = {k: v.clone() for k, v in eng.cache.pools.items()}
    pools = {k: v.clone() for k, v in eng.cache.pools.items()}
    dev = eng.device

    def lanes(v, fill):
        return torch.tensor([v] + [fill] * (DECODE_BATCH - 1),
                            dtype=torch.int32, device=dev)
    fed, steps = [seq.out[-1]], []
    for i in range(c):
        with OpRecorder() as rec:
            logits, pools = api.decode_step_paged(
                eng.params, lanes(fed[-1], 0), lanes(pos + i, 0), refs, pools,
                cfg)
        steps.append(rec.calls)
        fed.append(int(logits[0, :cfg.vocab_size].argmax()))
    tokens = torch.zeros((DECODE_BATCH, c), dtype=torch.int32, device=dev)
    tokens[0] = torch.tensor(fed[:c], dtype=torch.int32)
    no_eos = torch.full((DECODE_BATCH, 1), -1, dtype=torch.int32, device=dev)
    with OpRecorder() as vrec:
        api.verify_paged(eng.params, tokens, lanes(pos, 0), lanes(c, 1),
                         refs, pools0, None, None, None, None, no_eos, cfg,
                         use_top_k=False, stochastic=False, use_eos=False)
    torch.cuda.synchronize()
    res = {}
    for i, calls in enumerate(steps):
        if len(calls) != len(vrec.calls):
            raise AssertionError(f"[{label}] {len(calls)} decode ops, "
                                 f"{len(vrec.calls)} verify ops")
        attended, first, logits_diff = 0, None, None
        for (name, dout), (vname, vout) in zip(calls, vrec.calls):
            if name != vname:
                raise AssertionError(f"[{label}] op order {name}/{vname}")
            drows = _lane0_rows(torch, dout, DECODE_BATCH, 1, 0)
            vrows = _lane0_rows(torch, vout, DECODE_BATCH, c, i)
            diff = max(((a - b).abs().max().item()
                        for a, b in zip(drows, vrows)), default=0.0)
            if name == "lm_logits":
                logits_diff = diff
            if first is None and diff > 0:
                first = dict(op=name, attention_calls_before=attended,
                             max_abs_diff=diff)
            attended += name == "paged_attend"
        res[f"slot{i}"] = dict(first_difference=first,
                               logits_max_abs_diff=logits_diff)
    log(f"[{label} exact] verify slot vs decode step, first differing op "
        "(after how many attention calls): " + json.dumps(res))
    res["all_slots_bitwise"] = all(v["first_difference"] is None
                                   for v in res.values())
    eng.cancel(seq)
    eng.cache.check_refcounts()
    return res


def sole_ngram_trace(torch, cfg, params):
    """Phase 4: SOLE mode (bf16) with the n-gram drafter runs to the end:
    every request its budget, finish reasons, no page in use; each verify
    dispatch launches 24 attention and 49 calibrating norms. SOLE tokens
    differ from plain decode by design (a norm calibrates over the whole
    dispatch)."""
    from repro_torch.serve.spec import NGramDrafter
    reqs = trace_requests(cfg)
    plain = run_spec_trace(torch, cfg, params, reqs)
    run = run_spec_trace(torch, cfg, params, reqs, NGramDrafter())
    if any(len(o) != NEW_TOKENS for o in run["outs"]):
        raise AssertionError("[sole ngram] token counts")
    if run["stats"]["finish_reasons"] != {"length": len(reqs)}:
        raise AssertionError(f"[sole ngram] finish reasons "
                             f"{run['stats']['finish_reasons']}")
    if not run["per_verify"]:
        raise AssertionError("[sole ngram] no verify dispatch")
    want = check_per_verify("sole ngram", run["per_verify"], cfg, True,
                            False)
    summ = spec_summary("bf16 sole ngram", run, plain["wall_s"])
    agree = sum(a == b for x, y in zip(plain["outs"], run["outs"])
                for a, b in zip(x, y)) / (len(reqs) * NEW_TOKENS)
    summ.update(launches_per_verify=want, launches=run["launches"],
                token_agreement_with_plain=agree,
                plain_wall_s=plain["wall_s"])
    log(f"[bf16 sole ngram] tokens equal to plain SOLE decode: {agree:.3f} "
        "(not a bar: calibration spans the dispatch)")
    return summ


def profile_spec(torch, cfg, params):
    """Where the time goes in a speculative trace: the oracle trace (bf16,
    exact mode) under torch.profiler; device-busy share of the wall."""
    from torch.profiler import ProfilerActivity, profile
    cfg = dataclasses.replace(cfg, softmax_mode="exact", norm_mode="exact",
                              logit_int8=False)
    reqs = trace_requests(cfg)
    plain = run_spec_trace(torch, cfg, params, reqs)
    oracle = {i: list(o) for i, o in enumerate(plain["outs"])}
    res = {}
    for name, drafter in (("plain", None), ("oracle", OracleDrafter(oracle))):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run = run_spec_trace(torch, cfg, params, reqs, drafter)
        rows = device_rows(torch, prof)
        busy = sum(r[0] for r in rows) / 1e6
        res[name] = dict(wall_s=run["wall_s"], device_busy_s=busy,
                         busy_share=busy / run["wall_s"],
                         kernels=sum(r[1] for r in rows),
                         draft_host_s=run["draft_host_s"])
        log(f"[bf16 exact {name}, profiled] wall {run['wall_s']:.3f} s, "
            f"device busy {busy:.3f} s ({busy / run['wall_s']:.3f} of wall), "
            f"{res[name]['kernels']} device kernels")
    return res


def draft_model_pair(torch):
    """Phase 4: nemotron_4_15b (bf16, exact mode) served with
    ``--spec-decode draft:minitron_8b`` (the SOLE draft model's weights
    from seed 1): both at full width, peak device memory printed. With
    random weights acceptance is near 0: the phase checks the draft
    path's kernels (each draft forward launches E2Softmax once per layer
    and 2L + 1 calibrating norms) and memory, not speed."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import api
    from repro_torch.serve.spec import spec_config_from_flag
    target = dataclasses.replace(get_config("nemotron_4_15b"),
                                 softmax_mode="exact", norm_mode="exact",
                                 logit_int8=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    params = api.init_params(0, target, "cuda")
    spec = spec_config_from_flag("draft:minitron_8b", target,
                                 max_k=VERIFY_K, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.time() - t0
    resident = torch.cuda.memory_allocated() / 2 ** 30
    drafter = spec.drafter
    dcfg = drafter.cfg
    reqs = trace_requests(target, SPEC_NEW_TOKENS)[:DECODE_BATCH]
    draft_launches = []
    real_propose = drafter.propose

    def counted(lanes, ks):
        before = read_launches()
        f0 = drafter.forwards
        out = real_propose(lanes, ks)
        after = read_launches()
        draft_launches.append(({k: after[k] - before[k] for k in after},
                               drafter.forwards - f0))
        return out
    drafter.propose = counted
    try:
        run = run_spec_trace(torch, target, params, reqs, drafter)
    finally:
        drafter.propose = real_propose
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if any(len(o) != SPEC_NEW_TOKENS for o in run["outs"]):
        raise AssertionError("[draft pair] token counts")
    check_per_verify("draft pair", run["per_verify"], target, False, False)
    fwd = sum(f for _, f in draft_launches)
    tot = {k: sum(d[k] for d, _ in draft_launches)
           for k in draft_launches[0][0]} if draft_launches else {}
    want = {"e2softmax": dcfg.n_layers * fwd,
            "ailayernorm_calib": (2 * dcfg.n_layers + 1) * fwd}
    if not fwd or any(tot.get(k) != v for k, v in want.items()):
        raise AssertionError(f"[draft pair] draft forwards {fwd}, launches "
                             f"{tot}, expected {want}")
    summ = spec_summary("nemotron_4_15b + draft:minitron_8b", run)
    summ.update(init_s=init_s, resident_gib=resident, peak_gib=peak,
                draft_forwards=fwd, draft_launches=tot,
                launches=run["launches"],
                target=target.name, draft=dcfg.name)
    log(f"[draft pair] nemotron_4_15b target (exact, bf16) with a "
        f"minitron_8b draft ({dcfg.softmax_mode} softmax): init {init_s:.2f}"
        f" s, {resident:.2f} GiB resident, peak device memory {peak:.3f} "
        f"GiB; {fwd} draft forwards launched {json.dumps(tot)}")
    del params, spec, drafter
    torch.cuda.empty_cache()
    return summ


def open_loop_trace(torch, cfg, params, replicas=True):
    """Phase 4, the streaming front end at full width (bf16, exact mode):
    the ten trace requests arrive as a Poisson process (``OPEN_LOOP_RATE``
    requests per engine step, seed 0) through ``AsyncEngine``; one is
    cancelled after its first token surfaces, one while still queued.
    Prints TTFT and ITL in steps and wall ms (p50/p99), checks the pages
    are released and the other requests' tokens equal the closed batch's;
    then the same trace, without cancellations, through two replicas on
    this card (``ReplicatedAsyncEngine``, one shared parameter tree): each
    request's tokens equal the closed batch's."""
    import numpy as np
    from repro_torch.serve.loop import AsyncEngine, ReplicatedAsyncEngine
    cfg = dataclasses.replace(cfg, softmax_mode="exact", norm_mode="exact",
                              logit_int8=False)
    reqs = trace_requests(cfg)
    closed = run_spec_trace(torch, cfg, params, reqs)["outs"]
    arrivals = np.cumsum(np.random.default_rng(0).exponential(
        1.0 / OPEN_LOOP_RATE, len(reqs))).astype(int).tolist()
    cancel_live, cancel_queued = 1, len(reqs) - 1
    loop = AsyncEngine(spec_engine(cfg, params))
    reset_launches()
    t0 = time.perf_counter()
    hs = [loop.add_request(r, arrival=a) for r, a in zip(reqs, arrivals)]
    hs[cancel_queued].cancel()
    while loop.has_work:
        loop.step()
        h = hs[cancel_live]
        if h.tokens and not h.finished:
            h.cancel()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    eng = loop.engine
    eng.cache.check_refcounts()
    st = loop.stats()
    if eng.cache.blocks_in_use:
        raise AssertionError(f"[open loop] {eng.cache.blocks_in_use} pages "
                             "in use")
    want_reasons = {"cancelled": 2, "length": len(reqs) - 2}
    if st["finish_reasons"] != want_reasons:
        raise AssertionError(f"[open loop] finish reasons "
                             f"{st['finish_reasons']}")
    if hs[cancel_queued].tokens or not hs[cancel_live].tokens:
        raise AssertionError("[open loop] the cancellations did not land")
    for i, h in enumerate(hs):
        if i in (cancel_live, cancel_queued):
            if h.tokens != closed[i][:len(h.tokens)]:
                raise AssertionError(f"[open loop] cancelled request {i}")
        elif h.tokens != closed[i]:
            raise AssertionError(f"[open loop] request {i} differs from the "
                                 "closed batch")
    if launches["paged_e2softmax"] <= 0:
        raise AssertionError("[open loop] no paged attention launch")
    log(f"[open loop] rate {OPEN_LOOP_RATE}/step, arrivals {arrivals}: wall "
        f"{wall:.3f} s, {eng.steps} engine steps; TTFT steps "
        f"{st['ttft_steps']}, ms {st['ttft_ms']}; ITL steps "
        f"{st['itl_steps']}, ms {st['itl_ms']}; finish reasons "
        f"{st['finish_reasons']}; request {cancel_live} cancelled after "
        f"{len(hs[cancel_live].tokens)} tokens, request {cancel_queued} while "
        f"queued; launches {json.dumps(launches)}")
    out = dict(arrivals=arrivals, wall_s=wall, steps=eng.steps,
               ttft_steps=st["ttft_steps"], itl_steps=st["itl_steps"],
               ttft_ms=st["ttft_ms"], itl_ms=st["itl_ms"],
               finish_reasons=st["finish_reasons"], launches=launches)
    if not replicas:
        return out
    first = spec_engine(cfg, params)
    rep = ReplicatedAsyncEngine([first, spec_engine(cfg, first.params)])
    t0 = time.perf_counter()
    hs = [rep.add_request(r, arrival=a) for r, a in zip(reqs, arrivals)]
    rep.run()
    torch.cuda.synchronize()
    rwall = time.perf_counter() - t0
    for r in rep.replicas:
        r.engine.cache.check_refcounts()
        if r.engine.cache.blocks_in_use:
            raise AssertionError("[replicas] pages in use")
    if [h.tokens for h in hs] != closed:
        raise AssertionError("[replicas] tokens differ from one engine's")
    rst = rep.stats()
    per = [dict(completed=s["completed"], ttft_steps=s["ttft_steps"],
                itl_steps=s["itl_steps"], ttft_ms=s["ttft_ms"],
                itl_ms=s["itl_ms"]) for s in rst["per_replica"]]
    log(f"[replicas] 2 engines on one card: wall {rwall:.3f} s, tokens equal "
        f"to one engine's closed batch; routed {rst['routed_by_prefix']} by "
        f"prefix, {rst['routed_by_load']} by load; per replica "
        + json.dumps(per))
    out["replicas"] = dict(wall_s=rwall, routed_by_prefix=rst[
        "routed_by_prefix"], routed_by_load=rst["routed_by_load"],
        per_replica=per, steps=rst["steps"])
    return out


def small_spec_parity(torch):
    """Phase 4, smoke size: the spec engine (n-gram drafter; a 32-token
    vocabulary and prompts covering it, so every lane drafts) in exact and
    SOLE mode, and ``AsyncEngine`` (exact mode, staggered arrivals), on the
    card against the same on the CPU, under the smoke engines' bar (95% of
    greedy tokens equal)."""
    import numpy as np
    from repro_torch.configs.base import get_config
    from repro_torch.models import api
    from repro_torch.serve.engine import PagedEngine, Request
    from repro_torch.serve.loop import AsyncEngine
    from repro_torch.serve.spec import NGramDrafter, SpecConfig
    exact = dict(softmax_mode="exact", norm_mode="exact", logit_int8=False)
    kw = dict(num_blocks=32, block_size=8, max_seq_len=64, decode_batch=4,
              prefill_chunk=8)
    for mode, change in (("exact", exact), ("sole", {})):
        cfg = dataclasses.replace(get_config("qwen2_0_5b").smoke(),
                                  vocab_size=32, **change)
        params = api.init_params(0, cfg, "cpu")
        rng = np.random.default_rng(44)
        reqs = [Request(prompt=rng.permutation(32).astype(np.int32),
                        max_new_tokens=8) for _ in range(5)]
        outs = []
        for dev in ("cpu", "cuda"):
            eng = PagedEngine(cfg, params, device=dev, spec_config=SpecConfig(
                NGramDrafter(), max_k=4), **kw)
            outs.append(eng.generate(reqs))
            eng.cache.check_refcounts()
            if not eng.stats()["spec_dispatches"]:
                raise AssertionError(f"smoke spec {mode}: no verify")
        check_agreement(outs, f"paged spec ngram {mode}", 0.95)
    cfg = dataclasses.replace(get_config("qwen2_0_5b").smoke(), **exact)
    params = api.init_params(0, cfg, "cpu")
    rng = np.random.default_rng(1)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, n)
                    .astype(np.int32), max_new_tokens=8)
            for n in (5, 20, 12, 30, 9)]
    outs = []
    for dev in ("cpu", "cuda"):
        loop = AsyncEngine(PagedEngine(cfg, params, device=dev, **kw))
        hs = [loop.add_request(r, arrival=2 * i) for i, r in enumerate(reqs)]
        loop.run()
        loop.engine.cache.check_refcounts()
        outs.append([h.tokens for h in hs])
    check_agreement(outs, "async exact", 0.95)


# -- row stability: verify rows as decode rows, the exact-mode norms ---------


def decode_rows_case(torch, case):
    """A causal verify case (kernel layout) as the model's verify now
    attends it (``layers.decode_rows``): each of the B x C query rows a
    single-row query keyed ``min(q_start + j + 1, kv_len)``, its lane's
    table repeated, no causal mask."""
    q, pk, pv, tables, meta = case
    b, h, c, d = q.shape
    rows = q.permute(0, 2, 1, 3).reshape(b * c, h, 1, d).contiguous()
    j = torch.arange(c, device=q.device)
    lens = torch.minimum(meta[:, :1] + j + 1, meta[:, 1:]).reshape(-1)
    m = torch.stack([lens - 1, lens], 1).to(torch.int32).contiguous()
    return rows, pk, pv, tables.repeat_interleave(c, 0).contiguous(), m


def verify_rows_as_decode(torch, cfg, mini, attn):
    """Repair of the verify/decode split, phase 3. (a) ``paged_attend`` as
    ``verify_paged`` calls it (8 lanes x C = 5 causal rows, ragged
    n_valid, null lanes; random q) against the decode step at each valid
    row's position (8 lanes, kv_len = position + 1): asserted bitwise at
    qwen2_0_5b's head dim 64 (tensor cores) and minitron_8b's 128 (CUDA
    cores), on bf16 pages, int8 pages and int8 pages at w8a8 (``quant_pv``),
    in SOLE and exact mode. (b) The decode kernel on the verify timing
    cases as rows (``decode_rows_case``) against its plain version: exact
    mode to 1e-4 of the output scale, SOLE at most 1% of rows off by more
    than 1e-3; returns those cases for the timings beside the chunk
    route's."""
    from repro_torch.configs.base import QuantConfig
    from repro_torch.kernels import flash_e2softmax as KA
    from repro_torch.models import layers as L
    from repro_torch.models.layers import LOGIT_INT8_SCALE
    gen = torch.Generator(device="cuda").manual_seed(22)
    c = VERIFY_K + 1
    q_start, kv = verify_lanes(c)
    n_valid = [k - q for k, q in zip(kv, q_start)]
    exact = dict(softmax_mode="exact", norm_mode="exact", logit_int8=False)
    summary = {}
    for model in (cfg, mini):
        h, kvh, d = model.n_heads, model.n_kv_heads, model.head_dim
        for pool in ("bf16", "int8", "int8_qpv"):
            case = paged_case(torch, gen, b=DECODE_BATCH, c=c,
                              q_start=q_start, kv_lens=kv, h=h, kvh=kvh, d=d,
                              grid=False, int8=pool != "bf16")
            qk, pk, pv, tables, meta = case
            q = qk.transpose(1, 2).contiguous()            # (B, C, H, d)
            qs, kl = meta[:, 0], meta[:, 1]
            for mode in ("exact", "sole"):
                kw = dict(kv_cache_dtype="auto" if pool == "bf16" else "int8")
                if pool == "int8_qpv":
                    kw["quant"] = QuantConfig("w8a8")
                if mode == "exact":
                    kw.update(exact)
                mcfg = dataclasses.replace(model, **kw)
                rows = L.paged_attend(q, pk, pv, tables, qs, kl, mcfg,
                                      causal=True, rows_as_decode=True)
                same = total = 0
                for j in range(c):
                    dec = L.paged_attend(q[:, j:j + 1].contiguous(), pk, pv,
                                         tables, qs + j, qs + j + 1, mcfg,
                                         causal=False)
                    for lane in range(DECODE_BATCH):
                        if j < n_valid[lane]:
                            same += int(torch.equal(rows[lane, j],
                                                    dec[lane, 0]))
                            total += 1
                torch.cuda.synchronize()
                key = f"d{d}_{pool}_{mode}"
                summary[key] = dict(rows=total, bitwise_rows=same)
                log(f"verify rows as decode rows {key} (H {h}/KV {kvh}): "
                    f"{same}/{total} valid rows bitwise equal to the decode "
                    "step's")
                if same != total:
                    raise AssertionError(f"verify rows {key}: {same}/{total} "
                                         "bitwise equal to decode rows")
    cases = {}
    for name in ("verify", "minitron_verify"):
        case = decode_rows_case(torch, attn[name]["case"])
        h, kvh, d = case_dims(case)
        kvmap = KA.default_kv_head_map(h, kvh, "cuda")
        errs = {}
        for mode in ("exact", "sole"):
            kw = dict(sole=mode == "sole", exp_bits=cfg.exp_bits,
                      int8_scale=LOGIT_INT8_SCALE if mode == "sole" else None)
            out = KA.flash_e2softmax_paged(*case, causal=False, **kw)
            ref = KA.flash_e2softmax_paged_plain(*case, kvmap, causal=False,
                                                 **kw)
            torch.cuda.synchronize()
            err = (out - ref).abs()
            scale = max(ref.abs().max().item(), 1.0)
            errs[mode] = err.max().item()
            if mode == "exact" and errs[mode] > 1e-4 * scale:
                raise AssertionError(f"paged {name} rows exact: {errs[mode]}")
            off = (err.amax(-1) > 1e-3 * scale).float().mean().item()
            if mode == "sole" and off > 0.01:
                raise AssertionError(f"paged {name} rows sole: {off} of rows "
                                     "off by > 1e-3")
        log(f"paged_e2softmax {name}_rows [{tuple(case[0].shape)}, decode "
            f"route]: max|err| against the plain version exact "
            f"{errs['exact']:.3e}, sole {errs['sole']:.3e}")
        cases[f"{name}_rows"] = dict(case=case, causal=False,
                                     max_abs_err=errs["exact"],
                                     max_abs_err_random=errs["sole"])
    return summary, cases


# (C, rms) of the exact-mode norm: qwen2_0_5b's and mixtral_8x7b's RMS,
# minitron_8b's and dbrx_132b's LayerNorm
EXACT_NORM_CASES = ((896, True), (4096, True), (4096, False), (6144, False))
EXACT_NORM_ROWS = (1, 8, 40, 128, 2400)


def check_exact_norm(torch):
    """Repair of the exact-mode norms, phase 3: the exact-norm kernel on
    2,400 bf16 rows at each ``EXACT_NORM_CASES`` width; the first 1, 8,
    40 and 128 rows of a call of that many rows, and rows computed alone,
    bitwise equal to the same rows of the 2,400-row call (float32 out, and
    bf16 out equal to its cast); against the plain torch ops (another
    reduction order, torch's approximate rsqrt) to 1e-5 of the scale."""
    from repro_torch.kernels import ailayernorm as KN
    gen = torch.Generator(device="cuda").manual_seed(4)
    res = {}
    for c, rms in EXACT_NORM_CASES:
        n = max(EXACT_NORM_ROWS)
        x = (torch.randn((n, c), generator=gen, device="cuda") * 3
             + torch.randn((n, 1), generator=gen, device="cuda")).to(
                 torch.bfloat16)
        g = 1 + 0.1 * torch.randn((c,), generator=gen, device="cuda")
        b = None if rms else 0.1 * torch.randn((c,), generator=gen,
                                               device="cuda")
        eps = 1e-6 if rms else 1e-5
        full = KN.exact_norm(x, g, b, rms=rms, eps=eps)
        same = total = 0
        for rows in EXACT_NORM_ROWS[:-1]:
            same += int(torch.equal(KN.exact_norm(x[:rows], g, b, rms=rms,
                                                  eps=eps), full[:rows]))
            total += 1
        for i in (0, 1, 7, 39, 127, n // 2, n - 1):
            same += int(torch.equal(KN.exact_norm(x[i:i + 1], g, b, rms=rms,
                                                  eps=eps)[0], full[i]))
            total += 1
        half = KN.exact_norm(x, g, b, rms=rms, eps=eps,
                             out_dtype=torch.bfloat16)
        same += int(torch.equal(half, full.to(torch.bfloat16)))
        total += 1
        ref = KN.exact_norm_plain(x, g, b, rms=rms, eps=eps)
        torch.cuda.synchronize()
        err = (full - ref).abs().max().item()
        scale = ref.abs().max().item()
        name = f"{'rms' if rms else 'ln'}{c}"
        log(f"ailayernorm_exact {name}: {same}/{total} row-count checks "
            f"bitwise; max |err| against the plain torch ops {err:.3e} "
            f"(scale {scale:.3g})")
        if same != total:
            raise AssertionError(f"exact norm {name}: rows not stable")
        if err > 1e-5 * scale:
            raise AssertionError(f"exact norm {name}: {err} > 1e-5 x {scale}")
        res[name] = dict(x=x, g=g, b=b, rms=rms, eps=eps, max_abs_err=err)
    return res


def time_exact_norm(torch, norms, launches):
    """Phase 5 for the exact-mode norm kernel: CUDA events (L2 flushed)
    at a decode step's 8 rows, a verify dispatch's 40 and the dense
    prefill's 2,400, and at the train step's 8 x 1,024 rows of
    qwen2_0_5b's 896 (bf16 in and out, its compute type), beside its
    plain torch ops and one PyTorch call of the same function on a
    float32 copy of the rows (``rms_norm`` / ``layer_norm``, timed only);
    bound: the bf16 rows in, the output (float32, or bf16) out."""
    import torch.nn.functional as F
    from repro_torch.kernels import ailayernorm as KN
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda").zero_
    e = dict(name="ailayernorm_exact", route="cuda",
             source="src/repro_torch/kernels/csrc/ailayernorm.cu",
             replaces="src/repro/ops/reference.py:65 (exact_rmsnorm; with "
                      "exact_layernorm, :57, XLA's reduction: no pallas_call)",
             shapes={})
    # (name, the check's inputs, rows, out type)
    cases = [(name, res, rows, None) for name, res in norms.items()
             for rows in (DECODE_BATCH, VERIFY_ROWS, DECODE_BATCH * 300)]
    gen = torch.Generator(device="cuda").manual_seed(25)
    n = TRAIN_BATCH * TRAIN_SEQ
    xt = (torch.randn((n, 896), generator=gen, device="cuda") * 3
          + torch.randn((n, 1), generator=gen, device="cuda")).to(
              torch.bfloat16)
    cases.append(("rms896", dict(norms["rms896"], x=xt), n, torch.bfloat16))
    for name, res, rows, od in cases:
        x, g, b, rms, eps = (res[k] for k in ("x", "g", "b", "rms", "eps"))
        xr = x[:rows].contiguous()
        xf = xr.float()
        c = xr.shape[1]

        def run():
            return KN.exact_norm(xr, g, b, rms=rms, eps=eps, out_dtype=od)

        def plain():
            return KN.exact_norm_plain(xr, g, b, rms=rms, eps=eps)
        if rms:
            lib = getattr(F, "rms_norm", None)
            library = None if lib is None else (
                lambda: lib(xf, (c,), g, eps))
        else:
            library = lambda: F.layer_norm(xf, (c,), g, b, eps)  # noqa
        out_size = 4 if od is None else 2
        nbytes = (rows * c * (xr.element_size() + out_size)
                  + c * 4 * (1 + (not rms)))
        bms, by = bound_ms(nbytes, 8 * rows * c, FP32)
        key = f"{name}_rows{rows}" + ("" if od is None else "_train")
        e["shapes"][key] = dict(
            shape=f"rows {rows} C {c} {'rms' if rms else 'ln'} bf16 in, "
                  + ("float32 out" if od is None else
                     "bf16 out (the train step's)"),
            ms=time_ms(torch, run, flush),
            kernel_ms=profiled_kernel_ms(torch, run, flush,
                                         "exact_norm_kernel"),
            plain_ms=time_ms(torch, plain, flush, reps=10),
            library_ms=(None if library is None
                        else time_ms(torch, library, flush)),
            bound_ms=bms, bound_by=by, max_abs_err=res["max_abs_err"],
            bytes=nbytes)
    main = e["shapes"][f"rms896_rows{DECODE_BATCH}"]
    e.update(launches=launches["ailayernorm_exact"],
             launches_from="bf16 exact oracle spec trace (qwen2_0_5b)",
             max_abs_err=max(r["max_abs_err"] for r in norms.values()),
             ms=main["ms"], plain_ms=main["plain_ms"],
             bound_ms=main["bound_ms"], bound_by=main["bound_by"],
             library_ms=main["library_ms"],
             library="torch.nn.functional.rms_norm on a float32 copy")
    for s_, v in e["shapes"].items():
        k, lib = v["kernel_ms"], v["library_ms"]
        log(f"ailayernorm_exact {s_} [{v['shape']}]: {v['ms'] * 1e3:.1f} us "
            f"(profiler: kernel "
            f"{'not measured' if k is None else f'{k * 1e3:.1f} us'}; plain "
            f"{v['plain_ms'] * 1e3:.1f} us; library "
            f"{'none' if lib is None else f'{lib * 1e3:.1f} us'}; bound "
            f"{v['bound_ms'] * 1e3:.2f} us by {v['bound_by']})")
    return e


# -- the MoE family (mixtral_8x7b, dbrx_132b) -----------------------------------

# depth cut by the run's time limit (16 and 8 layers, 47 and 52 GB of bf16
# weights, fit in 80 GB and ran until the recurrent families joined)
MIXTRAL_LAYERS = 8                 # of 32
DBRX_LAYERS = 4                    # of 40


def profile_moe(torch, cfg, params, label):
    """``profile_engine``'s paged wave for an MoE model, with the expert
    FFN's share beside the paged attention's: CUDA events around every
    ``moe.expert_ffn`` call (the three expert products on the (E,
    capacity, d) buffer and the SwiGLU; the span may hold idle gaps)."""
    from repro_torch.models import moe as M
    spans, real = [], M.expert_ffn

    def timed(*a, **kw):
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        start.record()
        out = real(*a, **kw)
        end.record()
        spans.append((start, end))
        return out
    M.expert_ffn = timed
    try:
        prof = profile_engine(torch, cfg, params, label)
    finally:
        M.expert_ffn = real
    torch.cuda.synchronize()
    # the warm-up request's calls come first; the wave's are the rest
    n = int(round(prof["forwards"] * cfg.n_layers))
    ms = sum(s.elapsed_time(e) for s, e in spans[-n:]) if n else 0.0
    busy = prof["device_busy_s"] * 1e3
    prof.update(expert_ffn_ms=ms, expert_ffn_calls=n,
                expert_ffn_share_of_busy=ms / busy,
                attention_share_of_busy=prof["attention_kernel_ms"] / busy)
    log(f"[{label}] expert FFN {ms:.2f} ms over {n} calls "
        f"({ms / busy:.3f} of device busy) against the paged attention's "
        f"{prof['attention_kernel_ms']:.2f} ms "
        f"({prof['attention_kernel_ms'] / busy:.3f})")
    return prof


def serve_moe(torch):
    """Phase 4 for the MoE family at full width, depth cut to fit 80 GB
    (random weights from a seed, bf16, SOLE): mixtral_8x7b at
    ``MIXTRAL_LAYERS`` layers through ``PagedEngine`` (the launch checks of
    every paged trace: attention L, the calibrating norm 2L + 1 per
    forward, no ``qnorm``; finish reasons, refcounts, peak memory), the
    dense-slot ``Engine`` (E2Softmax L per call), exact-mode oracle,
    anti-oracle and n-gram spec traces beside plain giving plain decode's
    tokens (the row-stable products of decode and verify dispatches; the
    anti-oracle's rejected drafts verify every step, where random weights
    leave the n-gram drafter nothing to propose), every verify slot's ops
    bitwise equal to the decode step's,
    one open-loop ``AsyncEngine`` trace with cancellations and one
    profiled paged wave with the expert FFN's share; then dbrx_132b at
    ``DBRX_LAYERS`` layers through ``PagedEngine``. Each model is freed
    before the next. Returns the launches and traces by path."""
    from repro_torch.configs.base import get_config
    out = {}
    mix = dataclasses.replace(get_config("mixtral_8x7b"),
                              n_layers=MIXTRAL_LAYERS)
    launches, trace, params = serve_full_width(torch, mix, "mixtral bf16")
    out["mixtral_bf16"] = (launches, trace)
    out["mixtral_dense_bf16"] = serve_dense_full_width(
        torch, mix, params, "mixtral dense bf16")
    spec = spec_traces(torch, mix, params, "mixtral bf16")
    spec["ops"] = verify_decode_ops(torch, mix, params, "mixtral bf16")
    if not spec["ops"]["all_slots_bitwise"]:
        raise AssertionError("mixtral exact: a verify slot parts from its "
                             "decode step")
    trace["spec"] = spec
    ol = open_loop_trace(torch, mix, params, replicas=False)
    trace["open_loop"] = ol
    out["mixtral_spec_oracle"] = (spec["oracle"]["launches"], {})
    out["mixtral_spec_ngram"] = (spec["ngram"]["launches"], {})
    out["mixtral_spec_anti_oracle"] = (spec["anti-oracle"]["launches"], {})
    out["mixtral_open_loop"] = (ol["launches"], {})
    trace["profile"] = profile_moe(torch, mix, params, "mixtral bf16")
    del params
    torch.cuda.empty_cache()
    dbrx = dataclasses.replace(get_config("dbrx_132b"), n_layers=DBRX_LAYERS)
    launches_d, trace_d, params_d = serve_full_width(torch, dbrx, "dbrx bf16")
    out["dbrx_bf16"] = (launches_d, trace_d)
    del params_d
    torch.cuda.empty_cache()
    return out


def small_moe_parity(torch):
    """Phase 4, smoke size: mixtral_8x7b's and dbrx_132b's smoke configs
    (float32, 4 experts, top-2) through ``PagedEngine`` and the dense-slot
    ``Engine`` on the card against the same engines on the CPU: in exact
    mode the tokens are equal; in SOLE mode the smoke engines' bar (95%
    of greedy tokens equal)."""
    import numpy as np
    from repro_torch.configs.base import get_config
    from repro_torch.models import api
    from repro_torch.serve.engine import Engine, PagedEngine, Request
    exact = dict(softmax_mode="exact", norm_mode="exact", logit_int8=False)
    for arch in ("mixtral_8x7b", "dbrx_132b"):
        for mode, change, bar in (("exact", exact, 1.0), ("sole", {}, 0.95)):
            cfg = dataclasses.replace(get_config(arch).smoke(), **change)
            params = api.init_params(0, cfg, "cpu")
            rng = np.random.default_rng(1)
            reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, n)
                            .astype(np.int32), max_new_tokens=8)
                    for n in (5, 20, 12, 30, 9)]
            outs, douts = [], []
            for dev in ("cpu", "cuda"):
                eng = PagedEngine(cfg, params, num_blocks=32, block_size=8,
                                  max_seq_len=64, decode_batch=4,
                                  prefill_chunk=8, device=dev)
                outs.append(eng.generate(reqs))
                eng.cache.check_refcounts()
                douts.append(Engine(cfg, params, batch_size=4, max_len=64,
                                    device=dev).generate(reqs))
            check_agreement(outs, f"{arch} paged {mode}", bar)
            check_agreement(douts, f"{arch} dense {mode}", bar)


# -- the recurrent families (rwkv6_7b, recurrentgemma_9b) -----------------------

# rwkv6's per-head GroupNorm rows (64 heads of 64 channels, an (H, hd)
# affine) at a decode step, a paged prefill chunk and the dense prefill
GROUPNORM_CASES = {"decode": DECODE_BATCH * 64,
                   "prefill": PREFILL_CHUNK * 64,
                   "dense_prefill": DECODE_BATCH * PREFILL_ROWS * 64}


def _groupnorm_rows(torch, gen, rows):
    x = torch.randn((rows, 64), generator=gen, device="cuda") * 3
    x[:, ::7] *= 8                             # outlier channels, alpha > 0
    g = 1 + 0.1 * torch.randn((64, 64), generator=gen, device="cuda")
    b = 0.1 * torch.randn((64, 64), generator=gen, device="cuda")
    return x, g, b


def _mqa_case(torch, gen, name, dtype, grid):
    """A paged case at recurrentgemma_9b's attention (16 query heads on
    one KV head of dimension 256), in ``dtype`` (bf16 or float32 q and
    pools)."""
    sh = (dict(b=1, c=PREFILL_CHUNK, q_start=[PREFILL_CHUNK],
               kv_lens=[2 * PREFILL_CHUNK]) if name == "prefill" else
          dict(b=DECODE_BATCH, c=1, q_start=[0] * DECODE_BATCH,
               kv_lens=[49, 300, 117, 1, 256, 83, 160, 1]))
    case = paged_case(torch, gen, h=16, kvh=1, d=256, grid=grid, **sh)
    return tuple(t.to(dtype) if t.is_floating_point() else t for t in case)


def hybrid_stage_inputs(torch, gen):
    """The hybrid dense path's ``_sole_probs`` inputs: ``decode_attend``'s
    (8, 16, 1, 384) logits over the rolling window cache, the valid
    columns broadcast over lanes and heads (stride 0); the prefill's
    (8, 16, 300, 300) logits under the causal mask broadcast over lanes
    and heads (shared positions: no padding mask)."""
    dev = "cuda"
    cols = torch.arange(DENSE_MAX_LEN, device=dev)
    valid = cols <= PREFILL_ROWS + 4
    dmask = torch.broadcast_to(valid[None, None, None],
                               (DECODE_BATCH, 16, 1, DENSE_MAX_LEN))
    pos = torch.arange(PREFILL_ROWS, device=dev)
    pmask = torch.broadcast_to((pos[:, None] >= pos[None])[None, None],
                               (DECODE_BATCH, 16, PREFILL_ROWS, PREFILL_ROWS))
    return {name: dict(logits=torch.randn(mask.shape, generator=gen,
                                          device=dev) * 4, mask=mask)
            for name, mask in (("hybrid_decode", dmask),
                               ("hybrid_prefill", pmask))}


def check_recurrent_kernels(torch):
    """Phase 3 at the recurrent families' new shapes: the calibrating norm
    with rwkv6's (64, 64) GroupNorm affine (``alpha``, ``scale`` and the
    output bitwise equal to its plain version on two calls; a (64, 64)
    affine of one repeated row gives the (64,) call's bits), the exact norm
    with it (each head's rows bitwise equal to a (64,) call on them alone;
    1e-5 of the scale from the plain ops), the paged kernel at the hybrid's
    attention (16 on 1 KV head, d 256: bf16 pools on the tensor cores,
    float32 pools on the CUDA cores, each case logging its route) at
    decode and a 128-row chunk (exact-logit inputs 1e-5 of
    the scale; random: SOLE at most 1% of rows off by more than 1e-3, exact
    1e-4 of the scale), the hybrid dense path's ``_sole_probs`` (bitwise
    equal to the chain, one launch, one device kernel a call) and
    ``layers.fma`` (``addcmul``) bitwise equal to ``fma32``."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ailayernorm as KN
    from repro_torch.kernels import flash_e2softmax as KA
    from repro_torch.models import layers as L
    gen = torch.Generator(device="cuda").manual_seed(22)
    res = {"gn_calib": {}, "gn_exact": {}, "mqa": {}}
    for name, rows in GROUPNORM_CASES.items():
        x, g, b = _groupnorm_rows(torch, gen, rows)
        want = KN.calibrated_norm_plain(x, None, g, b, rms=False)
        for _ in range(2):
            got = KN.calibrated_norm(x, None, g, b, rms=False)
            torch.cuda.synchronize()
            if not all(torch.equal(a, w) for a, w in zip(got[1:], want[1:])):
                raise AssertionError(f"calib groupnorm {name}: not bitwise")
        one = KN.calibrated_norm(x, None, g[9], b[9], rms=False)[1]
        rep = KN.calibrated_norm(x, None, g[9].expand(64, 64).contiguous(),
                                 b[9].expand(64, 64).contiguous(),
                                 rms=False)[1]
        if not torch.equal(one, rep):
            raise AssertionError(f"calib groupnorm {name}: the (G, C) path "
                                 "parts from the (C,) one")
        full = KN.exact_norm(x, g, b, rms=False, eps=1e-5)
        for hh in (0, 9, 63):
            if not torch.equal(full[hh::64], KN.exact_norm(
                    x[hh::64].contiguous(), g[hh], b[hh], rms=False,
                    eps=1e-5)):
                raise AssertionError(f"exact groupnorm {name}: head {hh}")
        ref = KN.exact_norm_plain(x, g, b, rms=False, eps=1e-5)
        torch.cuda.synchronize()
        err = (full - ref).abs().max().item()
        if err > 1e-5 * ref.abs().max().item():
            raise AssertionError(f"exact groupnorm {name}: {err}")
        res["gn_calib"][name] = dict(x=x, g=g, b=b, max_abs_err=0.0)
        res["gn_exact"][name] = dict(x=x, g=g, b=b, max_abs_err=err)
        log(f"groupnorm rows={rows} C=64 (64, 64) affine: calibrating norm "
            f"bitwise (alpha histogram "
            f"{torch.bincount(want[2], minlength=4).tolist()}), (G, C) of "
            f"one row = (C,); exact norm heads bitwise alone, {err:.3e} "
            "from the plain ops")
    kvmap = KA.default_kv_head_map(16, 1, "cuda")
    for name in ("decode", "prefill"):
        causal = name == "prefill"
        for dt, tag in ((torch.bfloat16, ""), (torch.float32, "_f32")):
            errs, offs = {}, {}
            for grid in (True, False):
                case = _mqa_case(torch, gen, name, dt, grid)
                route = KA.paged_variant(dt, dt, 256, BLOCK_SIZE)
                if route.startswith("bf16 mma") != (dt == torch.bfloat16):
                    raise AssertionError(f"paged d 256 {dt}: {route}")
                for mode in ("sole", "exact"):
                    kw = dict(sole=mode == "sole", exp_bits=4,
                              int8_scale=(L.LOGIT_INT8_SCALE
                                          if mode == "sole" else None))
                    out = KA.flash_e2softmax_paged(*case, causal=causal, **kw)
                    ref = KA.flash_e2softmax_paged_plain(
                        *case, kvmap, causal=causal, **kw)
                    torch.cuda.synchronize()
                    err = (out - ref).abs()
                    scale = max(ref.abs().max().item(), 1.0)
                    key = f"{mode}_{'grid' if grid else 'random'}"
                    errs[key] = err.max().item()
                    if not torch.isfinite(out).all():
                        raise AssertionError(f"paged d 256 {name}: non-finite")
                    if grid or mode == "exact":
                        tol = (1e-5 if grid else 1e-4) * scale
                        if errs[key] > tol:
                            raise AssertionError(
                                f"paged d 256 {name}{tag} {key}: "
                                f"{errs[key]} > {tol}")
                    else:
                        offs[key] = (err.amax(-1) > 1e-3 * scale).float(
                            ).mean().item()
                        if offs[key] > 0.01:
                            raise AssertionError(
                                f"paged d 256 {name}{tag} {key}: "
                                f"{offs[key]} of rows off")
            res["mqa"][f"hybrid_{name}{tag}"] = dict(
                case=case, causal=causal, route=route,
                max_abs_err=max(errs.values()),
                max_abs_err_random=max(v for k, v in errs.items()
                                       if "random" in k))
            log(f"paged_e2softmax d=256 H 16/KV 1 {name} "
                f"{'float32' if tag else 'bf16'} [{route}]: max|err| "
                + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
                + f"; SOLE random rows off by > 1e-3: {offs}")
    stage = hybrid_stage_inputs(torch, gen)
    res["e2_stage"] = check_sole_probs(torch, get_config("recurrentgemma_9b"),
                                       stage)
    res["e2_inputs"] = stage
    a, b, c = (torch.randn(1 << 20, generator=gen, device="cuda")
               for _ in range(3))
    if not torch.equal(L.fma(a, b, c), KN.fma32(a, b, c)):
        raise AssertionError("layers.fma on the card is not one rounding")
    log("layers.fma (addcmul) on the card: bitwise equal to fma32 on 2^20 "
        "random triples")
    return res


def time_recurrent_kernels(torch, rk, launches):
    """Phase 5 at the recurrent shapes: the paged kernel at d 256 / 16 on 1
    (CUDA events, the profiler's kernel time, its plain version, the bound,
    exact mode and SDPA on the gathered K/V); the calibrating and the exact
    norm with the (64, 64) GroupNorm affine (the latter beside
    ``F.group_norm``, the same exact function over (rows / 64, 4096) with
    per-channel weights, on the same float32 rows); the hybrid's
    ``_sole_probs`` stage by events, host wall and kernels per call beside
    the chain. ``launches`` by kernel from the full-width traces."""
    import torch.nn.functional as F
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ailayernorm as KN
    from repro_torch.kernels import e2softmax as KE
    from repro_torch.kernels import flash_e2softmax as KA
    from repro_torch.models import layers as L
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda").zero_
    table = []
    pe = dict(name="paged_e2softmax_mqa_d256", route="cuda",
              source="src/repro_torch/kernels/csrc/paged_e2softmax.cu",
              replaces="src/repro/kernels/flash_e2softmax.py:186",
              shapes={})
    kw = dict(sole=True, exp_bits=4, int8_scale=L.LOGIT_INT8_SCALE)
    kvmap = KA.default_kv_head_map(16, 1, "cuda")
    for name, res in rk["mqa"].items():
        case, causal = res["case"], res["causal"]

        def run():
            return KA.flash_e2softmax_paged(*case, causal=causal, **kw)
        nbytes, flops = attention_work(case, causal, 16, 1, 256)
        bms, by = bound_ms(nbytes, flops, FP32 if "f32" in name
                           else BF16)
        exact_ms, sdpa_ms = paged_exact_vs_sdpa(torch, case, kvmap, flush,
                                                causal)
        pe["shapes"][name] = dict(
            shape=f"q {tuple(case[0].shape)} {case[0].dtype} KV 1 kv_len "
                  f"{case[4][:, 1].tolist()}",
            ms=time_ms(torch, run, flush),
            kernel_ms=profiled_kernel_ms(torch, run, flush, "paged_e2softmax"),
            plain_ms=time_ms(torch, lambda: KA.flash_e2softmax_paged_plain(
                *case, kvmap, causal=causal, **kw), flush, reps=5),
            bound_ms=bms, bound_by=by, max_abs_err=res["max_abs_err"],
            exact_ms=exact_ms, library_ms=sdpa_ms, bytes=nbytes, flops=flops)
    main = pe["shapes"]["hybrid_decode"]
    pe.update(launches=launches["paged_e2softmax_mqa_d256"],
              max_abs_err=max(s["max_abs_err"] for s in pe["shapes"].values()),
              ms=main["ms"], plain_ms=main["plain_ms"],
              bound_ms=main["bound_ms"], bound_by=main["bound_by"],
              library_ms=main["library_ms"],
              library="scaled_dot_product_attention (exact, K/V gathered)")
    table.append(pe)
    for key, wrap, kern, src in (
            ("gn_calib", "ailayernorm_calib_groupnorm", "calib_norm_kernel",
             "src/repro/kernels/ailayernorm.py:305 (params=None, reached "
             "by repro/models/rwkv6.py:86-91 on the reference backend)"),
            ("gn_exact", "ailayernorm_exact_groupnorm", "exact_norm_kernel",
             "src/repro/ops/reference.py:57 (exact_layernorm; XLA's "
             "reduction: no pallas_call)")):
        e = dict(name=wrap, route="cuda",
                 source="src/repro_torch/kernels/csrc/ailayernorm.cu",
                 replaces=src, shapes={})
        for name, res in rk[key].items():
            x, g, b = res["x"], res["g"], res["b"]
            rows = x.shape[0]
            if key == "gn_calib":
                def run():
                    return KN.calibrated_norm(x, None, g, b, rms=False)

                def plain():
                    return KN.calibrated_norm_plain(x, None, g, b, rms=False)
                library = None
                ops_per = QNORM_OPS_PER_ELEMENT
            else:
                def run():
                    return KN.exact_norm(x, g, b, rms=False, eps=1e-5)

                def plain():
                    return KN.exact_norm_plain(x, g, b, rms=False, eps=1e-5)
                xg = x.reshape(rows // 64, 64 * 64)

                def library():
                    return F.group_norm(xg, 64, g.reshape(-1), b.reshape(-1),
                                        1e-5)
                ops_per = 8
            nbytes = 2 * rows * 64 * 4 + 2 * 64 * 64 * 4
            bms, by = bound_ms(nbytes, ops_per * rows * 64, FP32)
            e["shapes"][name] = dict(
                shape=f"rows {rows} C 64, (64, 64) affine, float32",
                ms=time_ms(torch, run, flush),
                kernel_ms=profiled_kernel_ms(torch, run, flush, kern),
                plain_ms=time_ms(torch, plain, flush, reps=10),
                wall_ms=wall_ms(torch, run),
                library_ms=None if library is None else time_ms(
                    torch, library, flush),
                bound_ms=bms, bound_by=by, max_abs_err=res["max_abs_err"],
                bytes=nbytes)
        main = e["shapes"]["decode"]
        e.update(launches=launches[wrap],
                 max_abs_err=max(s["max_abs_err"]
                                 for s in e["shapes"].values()),
                 ms=main["ms"], plain_ms=main["plain_ms"],
                 bound_ms=main["bound_ms"], bound_by=main["bound_by"],
                 library_ms=main["library_ms"],
                 library=(None if key == "gn_calib" else
                          "torch.nn.functional.group_norm (64 groups)"))
        table.append(e)
    cfg = get_config("recurrentgemma_9b")
    e = dict(name="e2softmax_hybrid", route="cuda",
             source="src/repro_torch/kernels/csrc/e2softmax.cu",
             replaces="src/repro/kernels/e2softmax.py:48", shapes={})
    for name, inp in rk["e2_inputs"].items():
        logits, mask = inp["logits"], inp["mask"]

        def one():
            return L._sole_probs(logits, mask, cfg, torch.bfloat16)

        def chain():
            return sole_probs_chain(torch, cfg, logits, mask, KE.e2softmax)
        nbytes = logits.numel() * 4 + distinct_bytes(mask) + logits.numel() * 2
        bms, by = bound_ms(nbytes, E2_OPS_PER_ELEMENT * logits.numel(),
                           FP32)
        e["shapes"][name] = dict(
            shape=f"logits {tuple(logits.shape)} f32, mask strides "
                  f"{tuple(mask.stride())}, bf16 out",
            ms=time_ms(torch, one, flush),
            kernel_ms=profiled_kernel_ms(torch, one, flush, "e2softmax"),
            plain_ms=time_ms(torch, lambda: sole_probs_chain(
                torch, cfg, logits, mask, KE.e2softmax_plain), flush, reps=5),
            wall_ms=wall_ms(torch, one), chain_ms=time_ms(torch, chain, flush),
            kernels_per_call=rk["e2_stage"][name]["device_kernels"],
            bound_ms=bms, bound_by=by, max_abs_err=0.0, bytes=nbytes)
    main = e["shapes"]["hybrid_decode"]
    e.update(launches=launches["e2softmax_hybrid"], max_abs_err=0.0,
             ms=main["ms"], plain_ms=main["plain_ms"],
             bound_ms=main["bound_ms"], bound_by=main["bound_by"],
             library_ms=None)
    table.append(e)
    for t in table:
        for s, v in t["shapes"].items():
            k, lib = v["kernel_ms"], v.get("library_ms")
            log(f"{t['name']} {s} [{v['shape']}]: {v['ms'] * 1e3:.1f} us "
                f"(profiler: kernel "
                f"{'not measured' if k is None else f'{k * 1e3:.1f} us'}; "
                f"plain {v['plain_ms'] * 1e3:.1f} us; library "
                f"{'none' if lib is None else f'{lib * 1e3:.1f} us'}; bound "
                f"{v['bound_ms'] * 1e3:.3f} us by {v['bound_by']})")
    return table


class ForwardCounter:
    """Counts model forwards (one ``layers.lm_logits`` call each, on every
    path of every family) until :meth:`close`."""

    def __init__(self):
        from repro_torch.models import layers as L
        self._L, self._real = L, L.lm_logits
        self.forwards = 0

        def counted(*a, **kw):
            self.forwards += 1
            return self._real(*a, **kw)
        L.lm_logits = counted

    def close(self):
        self._L.lm_logits = self._real


def recurrent_norms_per_forward(cfg) -> int:
    """SOLE norm launches of one forward: rwkv6 3 per layer (ln1, the
    GroupNorm, ln2), the hybrid 2 per layer, and the final norm."""
    return (3 if cfg.family == "ssm" else 2) * cfg.n_layers + 1


def recurrent_trace(torch, cfg, params, label, *, dense=False, chunk=None,
                    warm=False):
    """One full-width trace of a recurrent family, the counts set to 0
    just before and read just after: the trace's ten requests (wave 1;
    wave 2 a repeat of request 0 whose eos ids are every token wave 1
    drew, and a request on the shared system prompt) through
    ``PagedEngine`` (``chunk`` its prefill chunk) or the dense-slot
    ``Engine``; ``warm``: wave 1 cold, then wave 1 again (exact mode: the
    warm tokens must equal the cold ones; state checkpoints must hit).
    Checks token counts, finish reasons, drained slots and pages, and the
    launches per forward: the SOLE norms as calibrating-norm launches
    (exact mode: exact-norm launches), the hybrid's attention as one paged
    (paged) or E2Softmax (dense) launch per attention block, nothing
    else of ours. Returns (launches, summary)."""
    from repro_torch.models import rglru
    from repro_torch.serve.engine import Engine, PagedEngine, Request
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    if dense:
        eng = Engine(cfg, params, batch_size=DECODE_BATCH,
                     max_len=DENSE_MAX_LEN, device="cuda")
    else:
        eng = PagedEngine(cfg, params,
                          num_blocks=8 * MAX_SEQ_LEN // BLOCK_SIZE + 1,
                          block_size=BLOCK_SIZE, max_seq_len=MAX_SEQ_LEN,
                          max_running=8, decode_batch=DECODE_BATCH,
                          prefill_chunk=chunk or PREFILL_CHUNK,
                          decode_horizon=8, device="cuda")
        ckpt_s = [0.0]
        real_ckpt = eng._maybe_checkpoint

        def timed_ckpt(seq, boundary):
            t0 = time.perf_counter()
            real_ckpt(seq, boundary)
            ckpt_s[0] += time.perf_counter() - t0
        eng._maybe_checkpoint = timed_ckpt
    prompts, tail = trace_prompts(cfg)
    wave1 = [Request(prompt=p, max_new_tokens=NEW_TOKENS) for p in prompts]
    counter = ForwardCounter()
    reset_launches()
    try:
        torch.cuda.synchronize()
        t0 = time.time()
        out1 = eng.generate(wave1)
        torch.cuda.synchronize()
        t1 = time.time() - t0
        if warm:
            wave2 = wave1
        else:
            eos = sorted({t for o in out1 for t in o})
            wave2 = [Request(prompt=prompts[0], max_new_tokens=NEW_TOKENS,
                             eos_ids=tuple(eos)),
                     Request(prompt=tail, max_new_tokens=NEW_TOKENS)]
        t0 = time.time()
        out2 = eng.generate(wave2)
        torch.cuda.synchronize()
        t2 = time.time() - t0
    finally:
        counter.close()
    launches = read_launches()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    fwd = counter.forwards
    outs = out1 + out2
    if any(len(o) != NEW_TOKENS for o in out1):
        raise AssertionError(f"[{label}] wave 1 token counts")
    if not all(0 <= t < cfg.vocab_size for o in outs for t in o):
        raise AssertionError(f"[{label}] token id out of range")
    summary = {"wave1_s": t1, "wave2_s": t2, "forwards": fwd,
               "new_tokens": sum(len(o) for o in outs),
               "max_memory_allocated_gib": peak_gib}
    if warm:
        if cfg.norm_mode == "exact" and out2 != out1:
            diff = sum(a != b for x, y in zip(out1, out2)
                       for a, b in zip(x, y))
            raise AssertionError(f"[{label}] warm replay parts from cold "
                                 f"on {diff} tokens")
        summary["warm_equal_cold"] = out2 == out1
    else:
        eos_fired = eos_outcome(out2[0], set(eos))
        if len(out2[1]) != NEW_TOKENS:
            raise AssertionError(f"[{label}] wave 2 request 1 tokens")
        summary["eos_fired"] = eos_fired
    exact = cfg.norm_mode == "exact"
    norms = recurrent_norms_per_forward(cfg) * fwd
    nb = rglru.n_blocks(cfg) if cfg.family == "hybrid" else 0
    want = {k: 0 for k in launches}
    want["ailayernorm_exact" if exact else "ailayernorm_calib"] = norms
    want["e2softmax" if dense else "paged_e2softmax"] = nb * fwd
    if fwd <= 0 or launches != want:
        raise AssertionError(f"[{label}] launches {launches} over {fwd} "
                             f"forwards, expected {want}")
    if dense:
        summary.update(prefill_calls=eng.prefill_calls,
                       decode_calls=eng.decode_calls)
    else:
        st = eng.stats()
        eng.cache.check_refcounts()
        eng.slot_pool.check_slots()
        if st["state_slots_in_use"] or st["blocks_in_use"]:
            raise AssertionError(f"[{label}] slots or pages leaked: {st}")
        if warm and not st["checkpoint_hit_tokens"]:
            raise AssertionError(f"[{label}] no checkpoint hit: {st}")
        if warm and nb and not st["prefix_hit_tokens"]:
            raise AssertionError(f"[{label}] no page hit beside the "
                                 "checkpoint")
        summary.update(
            slot_bytes=st["state_bytes_per_slot"],
            checkpoints=st.get("state_checkpoints", 0),
            checkpoint_bytes=(st.get("state_checkpoints", 0)
                              * st["state_bytes_per_slot"]),
            checkpoint_hit_tokens=st.get("checkpoint_hit_tokens", 0),
            prefix_hit_tokens=st["prefix_hit_tokens"],
            checkpoint_host_s=ckpt_s[0], peak_slots=st[
                "peak_state_slots_in_use"], finish_reasons=st[
                "finish_reasons"])
    per_fwd = {k: v / fwd for k, v in launches.items() if v}
    log(f"[{label}] served {len(outs)} requests, {summary['new_tokens']} new "
        f"tokens: wave 1 {t1:.3f} s, wave 2 {t2:.3f} s; {fwd} forwards; "
        f"launches per forward {json.dumps(per_fwd)}; peak device memory "
        f"{peak_gib:.3f} GiB")
    log(f"[{label}] " + json.dumps({k: v for k, v in summary.items()
                                     if k not in ("wave1_s", "wave2_s")}))
    return launches, summary


def graph_device_ms(torch, fn, reps=10):
    """(device ms, device kernels) per call of ``fn``, a chain of many
    small kernels: captured once in a CUDA graph and replayed between CUDA
    events, so the interval holds the chain's device work without the
    host's launch gaps (plain events would time the host's pace once the
    launch queue fills); the kernels per call from ``torch.profiler`` (the
    most it records in three windows: a short window can drop records)."""
    from torch.profiler import ProfilerActivity, profile
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    kernels = 0
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kernels = max(kernels, sum(e.count for e in prof.key_averages()
                                   if _device_us(e) > 0))
    return start.elapsed_time(end) / reps, kernels


def recurrence_device_ms(torch, cfg, params):
    """Device time of the recurrence itself (``wkv_sequential`` or
    ``rg_lru``, one layer's call, replayed as a CUDA graph:
    :func:`graph_device_ms`) at a decode step (8 lanes, one token) and a
    prefill chunk (one lane, 128 tokens) on random inputs of the model's
    width, and its device kernels per call."""
    from repro_torch.models import rglru as TG
    from repro_torch.models import rwkv6 as TR
    gen = torch.Generator(device="cuda").manual_seed(7)
    out = {}
    for name, (b, s) in (("decode", (DECODE_BATCH, 1)),
                         ("chunk", (1, PREFILL_CHUNK))):
        if cfg.family == "ssm":
            h, d = cfg.n_heads, cfg.rwkv_head_size
            r, k, v = (torch.randn((b, s, h, d), generator=gen,
                                   device="cuda") for _ in range(3))
            w = torch.rand((b, s, h, d), generator=gen, device="cuda")
            u = params["layers"]["tm"]["u"][0]
            st = torch.randn((b, h, d, d), generator=gen, device="cuda")

            def fn():
                return TR.wkv_sequential(r, k, v, w, u, st)
        else:
            p = {k: v[0] for k, v in params["blocks"]["rec1"].items()
                 if not isinstance(v, dict)}
            x = torch.randn((b, s, cfg.d_model), generator=gen,
                            device="cuda").to(torch.bfloat16)
            h0 = torch.randn((b, cfg.d_model), generator=gen, device="cuda")

            def fn():
                return TG.rg_lru(x, x, p, cfg, h0)
        ms, kernels = graph_device_ms(torch, fn)
        out[name] = dict(ms=ms, device_kernels=kernels)
    return out


def profile_recurrent(torch, cfg, params, label, dense=False):
    """``profile_engine``'s wave for a recurrent family under the profiler:
    wall, device busy, device kernels per forward (forwards counted by
    ``lm_logits`` calls), the norm kernels' device time and share of busy,
    the host wall spent inside the recurrence's calls (``wkv_sequential``
    or ``rg_lru``), and the recurrence's device time estimated from
    :func:`recurrence_device_ms` (the wave's eight one-chunk prefills and
    its decode steps, every layer) and its share of busy."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import rglru as TG
    from repro_torch.models import rwkv6 as TR
    from repro_torch.serve.engine import Engine, PagedEngine, Request
    mod, fn_name = ((TR, "wkv_sequential") if cfg.family == "ssm"
                    else (TG, "rg_lru"))
    real = getattr(mod, fn_name)
    host = [0.0]

    def timed(*a, **kw):
        t0 = time.perf_counter()
        out = real(*a, **kw)
        host[0] += time.perf_counter() - t0
        return out
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
    setattr(mod, fn_name, timed)
    counter = ForwardCounter()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            eng.generate(reqs)
            torch.cuda.synchronize()
            wall = time.time() - t0
    finally:
        setattr(mod, fn_name, real)
        counter.close()
    rows = device_rows(torch, prof)
    busy = sum(r[0] for r in rows) / 1e6
    kernels = sum(n for _, n, _ in rows)
    norm_ms = sum(us for us, _, key in rows
                  if "calib_norm_kernel" in key or "exact_norm_kernel" in key
                  ) / 1e3
    fwd = counter.forwards
    rec = recurrence_device_ms(torch, cfg, params)
    layers = cfg.n_layers if cfg.family == "ssm" else (
        cfg.n_layers - (cfg.n_layers - cfg.n_tail_layers)
        // len(cfg.block_pattern))
    est_ms = layers * (DECODE_BATCH * rec["chunk"]["ms"]
                       + max(fwd - DECODE_BATCH, 0) * rec["decode"]["ms"])
    out = {"wall_s": wall, "device_busy_s": busy, "kernels": kernels,
           "forwards": fwd, "kernels_per_forward": kernels / max(fwd, 1),
           "norm_kernel_ms": norm_ms, "norm_share_of_busy": norm_ms / 1e3 / busy,
           "recurrence": fn_name, "recurrence_layers": layers,
           "recurrence_call_ms": rec,
           "recurrence_device_ms_estimate": est_ms,
           "recurrence_share_of_busy_estimate": est_ms / 1e3 / busy,
           "recurrence_host_s": host[0],
           "recurrence_host_share_of_wall": host[0] / wall,
           "top": [{"ms": us / 1e3, "count": n, "kernel": key[:100]}
                   for us, n, key in rows[:12]]}
    log(f"[{label}] profiled wave: wall {wall:.3f} s, device busy "
        f"{busy:.3f} s ({busy / wall:.3f} of wall), {kernels} kernels over "
        f"{fwd} forwards ({kernels / max(fwd, 1):.1f} per forward); norm "
        f"kernels {norm_ms:.2f} ms ({out['norm_share_of_busy']:.3f} of "
        f"busy); {fn_name}: {layers} calls a forward, device "
        f"{rec['decode']['ms'] * 1e3:.1f} us a decode call "
        f"({rec['decode']['device_kernels']:.0f} kernels), "
        f"{rec['chunk']['ms'] * 1e3:.1f} us a 128-token chunk "
        f"({rec['chunk']['device_kernels']:.0f} kernels), est. {est_ms:.1f} "
        f"ms ({out['recurrence_share_of_busy_estimate']:.3f} of busy); host "
        f"{host[0]:.3f} s in its calls ({host[0] / wall:.3f} of wall)")
    for us, n, key in rows[:12]:
        log(f"  {us / 1e3:9.2f} ms {n:7d} x  {key[:100]}")
    return out


def serve_recurrent(torch):
    """Phase 4 for the recurrent families at full width and full depth
    (random weights from a seed, bf16): rwkv6_7b (32 layers) and
    recurrentgemma_9b (38 layers), each through ``PagedEngine`` (SOLE, the
    two-wave trace with an eos request), ``PagedEngine`` in exact mode
    with prefill chunks of one block (a checkpoint at every block) cold and
    then warm (checkpoint, and for the hybrid page, hits; tokens equal to
    cold), the dense-slot ``Engine`` (SOLE) and a profiled paged wave;
    each model freed before the next. Returns the launches and summaries
    by path."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import api
    out = {}
    for arch, tag in (("rwkv6_7b", "rwkv6"), ("recurrentgemma_9b",
                                              "hybrid")):
        cfg = get_config(arch)
        t0 = time.time()
        before = torch.cuda.memory_allocated()
        params = api.init_params(0, cfg, "cuda")
        torch.cuda.synchronize()
        resident = (torch.cuda.memory_allocated() - before) / 2 ** 30
        log(f"[{tag}] init_params: {time.time() - t0:.2f} s, {resident:.3f} "
            f"GiB of weights ({before / 2 ** 30:.3f} GiB held before)")
        exact = dataclasses.replace(cfg, softmax_mode="exact",
                                    norm_mode="exact", logit_int8=False)
        res = {"resident_gib": resident}
        for key, c, kw in (("paged", cfg, {}),
                           ("paged_exact_warm", exact,
                            dict(chunk=BLOCK_SIZE, warm=True)),
                           ("dense", cfg, dict(dense=True))):
            res[key] = recurrent_trace(torch, c, params, f"{tag} {key}",
                                       **kw)
        res["profile"] = profile_recurrent(torch, cfg, params, f"{tag} paged")
        out[tag] = res
        del params
        torch.cuda.empty_cache()
    return out


def small_recurrent_parity(torch):
    """The smoke ssm and hybrid engines (the hybrid at 4 layers: one
    rec-rec-attention block, one tail layer; float32) through
    ``PagedEngine`` and the dense-slot ``Engine`` on the card against the
    same engines on the CPU: exact mode tokens equal, SOLE at least 95%."""
    import numpy as np
    from repro_torch.configs.base import get_config
    from repro_torch.models import api
    from repro_torch.serve.engine import Engine, PagedEngine, Request
    exact = dict(softmax_mode="exact", norm_mode="exact", logit_int8=False)
    for arch, over in (("rwkv6_7b", {}),
                       ("recurrentgemma_9b", dict(n_layers=4,
                                                  n_tail_layers=1))):
        for mode, change, bar in (("exact", exact, 1.0), ("sole", {}, 0.95)):
            cfg = dataclasses.replace(get_config(arch).smoke(), **over,
                                      **change)
            params = api.init_params(0, cfg, "cpu")
            rng = np.random.default_rng(1)
            reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, n)
                            .astype(np.int32), max_new_tokens=8)
                    for n in (5, 20, 12, 30, 9)]
            same = [Request(prompt=rng.integers(0, cfg.vocab_size, 12)
                            .astype(np.int32), max_new_tokens=8)
                    for _ in range(5)]
            outs, douts = [], []
            for dev in ("cpu", "cuda"):
                eng = PagedEngine(cfg, params, num_blocks=32, block_size=8,
                                  max_seq_len=64, decode_batch=4,
                                  prefill_chunk=8, device=dev)
                outs.append(eng.generate(reqs))
                eng.cache.check_refcounts()
                douts.append(Engine(cfg, params, batch_size=4, max_len=64,
                                    device=dev).generate(same))
            check_agreement(outs, f"{arch} paged {mode}", bar)
            check_agreement(douts, f"{arch} dense {mode}", bar)


# -- the encdec and vlm families (whisper_small, qwen2_vl_7b) --------------------

WHISPER_FRAMES = 1500              # 30 s of audio at 50 frames/s (cross_len)
WHISPER_PROMPTS = (4, 64, 16, 40, 8, 33, 24, 12)   # decoder prompt lengths
WHISPER_BLOCKS = 8 * (WHISPER_FRAMES // BLOCK_SIZE + 1 + 6) + 1
# the null page, two requests' cross pages (94 each) and their prompts'
# pages (1 + 4): any decode growth preempts
WHISPER_TIGHT_BLOCKS = 1 + 2 * (WHISPER_FRAMES // BLOCK_SIZE + 1) + 5
VLM_PROMPT = 1024                  # embeds a lane: a 16 x 16 patch grid, text
VLM_GRID = 16
VLM_LANES = 2
XATTN_VALID = (1500, 1200, 800, 1, 1500, 333, 1000, 1)   # cross_valid a lane
FAMILY_NORM_CASES = {"ln768_decode": (DECODE_BATCH, 768, False),
                     "ln768_chunk": (PREFILL_CHUNK, 768, False),
                     "ln768_encoder": (WHISPER_FRAMES, 768, False),
                     "rms3584_decode": (DECODE_BATCH, 3584, True),
                     "rms3584_prefill": (VLM_LANES * VLM_PROMPT, 3584, True)}


def family_stage_inputs(torch, gen):
    """The ``_sole_probs`` inputs of the two families' paths, raw float32
    logits and the mask as ``attend_dense`` hands it over: whisper's
    encoder (one request, 12 heads, 1,500 x 1,500, the all-true (S, T)
    mask broadcast over the batch and heads; and with a padded tail of 300
    columns), its cross-attention at a decode step (8 lanes x 12 heads x 1
    row of 1,500) and at a 64-row chunk of each lane, with the per-lane
    (B, 1, S, T) mask of ``XATTN_VALID`` at stride 0 over heads; qwen2-vl's
    prefill (2 lanes x 28 heads x 1,024 causal rows) and decode step (the
    (B, KV, g, T + 1) logits over its 1,056-column cache, the write slot
    masked)."""
    dev = "cuda"
    s = WHISPER_FRAMES
    cols = torch.arange(s, device=dev)
    enc = torch.ones((s, s), dtype=torch.bool, device=dev)
    tail = torch.broadcast_to(cols[None] < s - 300, (s, s))
    valid = torch.tensor(XATTN_VALID, device=dev)
    lane = cols[None] < valid[:, None]                       # (8, T)
    xdec = torch.broadcast_to(lane[:, None, None, :], (8, 12, 1, s))
    xchunk = torch.broadcast_to(lane[:, None, None, :], (8, 12, 64, s))
    n = VLM_PROMPT
    pos = torch.arange(n, device=dev)
    causal = torch.broadcast_to((pos[:, None] >= pos[None])[None, None],
                                (VLM_LANES, 28, n, n))
    t = VLM_PROMPT + NEW_TOKENS
    cvalid = torch.arange(t, device=dev) <= VLM_PROMPT + 4
    cvalid[VLM_PROMPT + 4] = False                           # the write slot
    vdec = torch.cat([torch.broadcast_to(cvalid[None, None, None],
                                         (VLM_LANES, 4, 7, t)),
                      torch.ones((VLM_LANES, 4, 7, 1), dtype=torch.bool,
                                 device=dev)], -1)
    masks = {"whisper_encoder": torch.broadcast_to(enc, (1, 12, s, s)),
             "whisper_encoder_tail": torch.broadcast_to(tail, (1, 12, s, s)),
             "whisper_xattn_decode": xdec, "whisper_xattn_chunk": xchunk,
             "vlm_prefill": causal, "vlm_decode": vdec}
    return {name: dict(logits=torch.randn(mask.shape, generator=gen,
                                          device=dev) * 4, mask=mask)
            for name, mask in masks.items()}


def _family_norm_rows(torch, gen, rows, c, rms):
    x = torch.randn((rows, c), generator=gen, device="cuda") * 3
    x[:, ::7] *= 8                             # outlier channels, alpha > 0
    x = x.to(torch.bfloat16)
    r = torch.randn((rows, c), generator=gen, device="cuda").to(x.dtype)
    g = 1 + 0.1 * torch.randn((c,), generator=gen, device="cuda")
    b = None if rms else 0.1 * torch.randn((c,), generator=gen, device="cuda")
    return x, r, g, b


def check_family_kernels(torch):
    """Phase 3 at the encdec and vlm families' shapes. E2Softmax: the path's
    whole ``_sole_probs`` stage (one launch) against the chain on the
    plain version at :func:`family_stage_inputs` (rows past 512 columns sum
    in another order: ``e2_match``'s bar), every masked entry, the padded
    tail's included, exactly 0. The calibrating norm (residual add,
    calibration, quantize + norm; and without the residual, the encoder's
    and decoder's first norm) bitwise equal to its plain version on two
    calls, and the exact norm's rows bitwise equal when computed alone and
    within 1e-5 of the scale of its plain torch ops, at LayerNorm 768 (8,
    128, 1,500 rows) and RMS 3,584 (8, 2,048 rows). The paged kernel at
    whisper's decoder attention (12 heads on 12 KV heads, d 64: the
    tensor-core route) at a decode step and a 128-row chunk, bf16 pages,
    SOLE and exact (exact-logit inputs to 1e-5 of the scale; random: SOLE
    at most 1% of rows off by more than 1e-3, exact 1e-4)."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ailayernorm as KN
    from repro_torch.kernels import e2softmax as KE
    from repro_torch.kernels import flash_e2softmax as KA
    from repro_torch.models import layers as L
    gen = torch.Generator(device="cuda").manual_seed(23)
    res = {"e2": {}, "calib": {}, "exact": {}, "paged": {}}
    cfgs = {"whisper": get_config("whisper_small"),
            "vlm": get_config("qwen2_vl_7b")}
    stage = family_stage_inputs(torch, gen)
    for name, inp in stage.items():
        logits, mask = inp["logits"], inp["mask"]
        cfg = cfgs[name.split("_")[0]]
        before = KE.e2softmax.launches
        probs = L._sole_probs(logits, mask, cfg, torch.bfloat16)
        if KE.e2softmax.launches != before + 1:
            raise AssertionError(f"_sole_probs {name}: not one launch")
        want = sole_probs_chain(torch, cfg, logits, mask, KE.e2softmax_plain)
        torch.cuda.synchronize()
        c = logits.shape[-1]
        err, off = e2_match(torch, probs.float().reshape(-1, c),
                            want.float().reshape(-1, c), c)
        if (probs[~torch.broadcast_to(mask, probs.shape)] != 0).any():
            raise AssertionError(f"_sole_probs {name}: a masked entry is "
                                 "not 0")
        res["e2"][name] = dict(logits=logits, mask=mask, cfg=cfg,
                               max_abs_err=err, rows_off=off)
        log(f"_sole_probs {name} logits {tuple(logits.shape)} mask strides "
            f"{tuple(mask.stride())}: one launch, max|err| {err:.3e} against "
            f"the plain chain, rows in another ALDivision bucket {off:.5f}, "
            "masked entries 0")
    for name, (rows, c, rms) in FAMILY_NORM_CASES.items():
        x, r, g, b = _family_norm_rows(torch, gen, rows, c, rms)
        pb = torch.zeros_like(g) if rms else b
        for rr in (r, None):
            want = KN.calibrated_norm_plain(x, rr, g, pb, rms=rms,
                                            out_dtype=x.dtype)
            for _ in range(2):
                got = KN.calibrated_norm(x, rr, g, b, rms=rms,
                                         out_dtype=x.dtype)
                torch.cuda.synchronize()
                if not all(torch.equal(p, q) for p, q in zip(got, want)):
                    raise AssertionError(f"calib norm {name}: not bitwise")
        eps = 1e-6 if rms else 1e-5
        full = KN.exact_norm(x, g, b, rms=rms, eps=eps)
        for i in (0, rows // 2, rows - 1):
            if not torch.equal(KN.exact_norm(x[i:i + 1], g, b, rms=rms,
                                             eps=eps)[0], full[i]):
                raise AssertionError(f"exact norm {name}: row {i} alone")
        ref = KN.exact_norm_plain(x, g, b, rms=rms, eps=eps)
        torch.cuda.synchronize()
        err = (full - ref).abs().max().item()
        if err > 1e-5 * ref.abs().max().item():
            raise AssertionError(f"exact norm {name}: {err}")
        res["calib"][name] = dict(x=x, r=r, gamma=g, beta=b, rms=rms,
                                  max_abs_err=0.0)
        res["exact"][name] = dict(x=x, g=g, b=b, rms=rms, eps=eps,
                                  max_abs_err=err)
        log(f"family norm {name} rows={rows} C={c}: calibrating norm bitwise "
            f"(with and without the residual), exact norm rows alone "
            f"bitwise, {err:.3e} from its plain ops")
    kvmap = KA.default_kv_head_map(12, 12, "cuda")
    shapes = {"decode": dict(b=DECODE_BATCH, c=1, q_start=[0] * DECODE_BATCH,
                             kv_lens=[49, 96, 17, 1, 64, 83, 40, 1]),
              "chunk": dict(b=1, c=PREFILL_CHUNK, q_start=[0],
                            kv_lens=[PREFILL_CHUNK])}
    for name, sh in shapes.items():
        causal = name == "chunk"
        errs, offs = {}, {}
        for grid in (True, False):
            case = paged_case(torch, gen, h=12, kvh=12, d=64, grid=grid, **sh)
            for mode in ("sole", "exact"):
                kw = dict(sole=mode == "sole", exp_bits=4,
                          int8_scale=(L.LOGIT_INT8_SCALE if mode == "sole"
                                      else None))
                out = KA.flash_e2softmax_paged(*case, causal=causal, **kw)
                ref = KA.flash_e2softmax_paged_plain(*case, kvmap,
                                                     causal=causal, **kw)
                torch.cuda.synchronize()
                err = (out - ref).abs()
                scale = max(ref.abs().max().item(), 1.0)
                key = f"{mode}_{'grid' if grid else 'random'}"
                errs[key] = err.max().item()
                if not torch.isfinite(out).all():
                    raise AssertionError(f"paged 12/12 {name}: non-finite")
                if grid or mode == "exact":
                    tol = (1e-5 if grid else 1e-4) * scale
                    if errs[key] > tol:
                        raise AssertionError(f"paged 12/12 {name} {key}: "
                                             f"{errs[key]} > {tol}")
                else:
                    offs[key] = (err.amax(-1) > 1e-3 * scale).float(
                        ).mean().item()
                    if offs[key] > 0.01:
                        raise AssertionError(f"paged 12/12 {name} {key}: "
                                             f"{offs[key]} of rows off")
        res["paged"][f"whisper_{name}"] = dict(
            case=case, causal=causal, max_abs_err=max(errs.values()))
        log(f"paged_e2softmax H 12/KV 12 d 64 {name} "
            f"[{KA.paged_variant(torch.bfloat16, torch.bfloat16, 64, BLOCK_SIZE)}]"
            ": max|err| " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
            + f"; SOLE random rows off by > 1e-3: {offs}")
    return res


def time_family_kernels(torch, fk, launches):
    """Phase 5 at the two families' shapes, four rows of the kernel table:
    the ``_sole_probs`` stage (one E2Softmax launch; bound: the logits, the
    distinct mask bytes and the bf16 output once), the calibrating norm's
    residual op stage and the exact norm (beside ``F.layer_norm`` /
    ``F.rms_norm`` on a float32 copy), and the paged kernel at 12 on 12
    heads (beside its exact mode and SDPA on the gathered K/V); each by
    CUDA events with L2 flushed, the kernel alone by the profiler, and its
    plain version. ``launches`` by row from the full-width paths."""
    import torch.nn.functional as F
    from repro_torch import ops
    from repro_torch.kernels import ailayernorm as KN
    from repro_torch.kernels import e2softmax as KE
    from repro_torch.kernels import flash_e2softmax as KA
    from repro_torch.models import layers as L
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda").zero_
    table = []
    e = dict(name="e2softmax_encdec_vlm", route="cuda",
             source="src/repro_torch/kernels/csrc/e2softmax.cu",
             replaces="src/repro/kernels/e2softmax.py:48", shapes={})
    for name, res in fk["e2"].items():
        logits, mask, cfg = res["logits"], res["mask"], res["cfg"]

        def one():
            return L._sole_probs(logits, mask, cfg, torch.bfloat16)
        nbytes = logits.numel() * 4 + distinct_bytes(mask) + logits.numel() * 2
        bms, by = bound_ms(nbytes, E2_OPS_PER_ELEMENT * logits.numel(),
                           FP32)
        e["shapes"][name] = dict(
            shape=f"logits {tuple(logits.shape)} f32, mask strides "
                  f"{tuple(mask.stride())}, bf16 out",
            ms=time_ms(torch, one, flush, reps=10),
            kernel_ms=profiled_kernel_ms(torch, one, flush, "e2softmax",
                                         reps=5),
            plain_ms=time_ms(torch, lambda: sole_probs_chain(
                torch, cfg, logits, mask, KE.e2softmax_plain), flush, reps=3),
            bound_ms=bms, bound_by=by, max_abs_err=res["max_abs_err"],
            rows_off=res["rows_off"], bytes=nbytes)
    main = e["shapes"]["whisper_xattn_decode"]
    e.update(launches=sum(launches["e2softmax_encdec_vlm"].values()),
             launches_by_path=launches["e2softmax_encdec_vlm"],
             max_abs_err=max(s["max_abs_err"] for s in e["shapes"].values()),
             ms=main["ms"], plain_ms=main["plain_ms"],
             bound_ms=main["bound_ms"], bound_by=main["bound_by"],
             library_ms=None, main_shape="whisper_xattn_decode")
    table.append(e)
    for key, wrap, kern in (("calib", "ailayernorm_calib_encdec_vlm",
                             "calib_norm_kernel"),
                            ("exact", "ailayernorm_exact_encdec_vlm",
                             "exact_norm_kernel")):
        e = dict(name=wrap, route="cuda",
                 source="src/repro_torch/kernels/csrc/ailayernorm.cu",
                 replaces=("src/repro/kernels/ailayernorm.py:305"
                           if key == "calib" else
                           "src/repro/ops/reference.py:57 (exact_layernorm; "
                           "with exact_rmsnorm, :65, XLA's reduction: no "
                           "pallas_call)"), shapes={})
        for name, res in fk[key].items():
            x, rms = res["x"], res["rms"]
            rows, c = x.shape
            kind = "rmsnorm" if rms else "layernorm"
            if key == "calib":
                r, g, b = res["r"], res["gamma"], res["beta"]
                stage = ops.resolve(f"residual_{kind}", "sole", "cuda")
                extra = () if rms else (b,)
                pb = torch.zeros_like(g) if rms else b

                def run():
                    return stage(x, r, g, *extra, out_dtype=x.dtype)

                def plain():
                    return KN.calibrated_norm_plain(x, r, g, pb, rms=rms,
                                                    out_dtype=x.dtype)
                library = None
                nbytes = 4 * rows * c * 2 + 2 * c * 4
                flops = QNORM_OPS_PER_ELEMENT * rows * c
            else:
                g, b, eps = res["g"], res["b"], res["eps"]
                xf = x.float()

                def run():
                    return KN.exact_norm(x, g, b, rms=rms, eps=eps)

                def plain():
                    return KN.exact_norm_plain(x, g, b, rms=rms, eps=eps)
                lib = getattr(F, "rms_norm", None)
                if rms:
                    library = None if lib is None else (
                        lambda: lib(xf, (c,), g, eps))
                else:
                    library = lambda: F.layer_norm(xf, (c,), g, b, eps)  # noqa
                nbytes = rows * c * (2 + 4) + c * 4 * (1 + (not rms))
                flops = 8 * rows * c
            bms, by = bound_ms(nbytes, flops, FP32)
            e["shapes"][name] = dict(
                shape=f"rows {rows} C {c} {'rms' if rms else 'ln'} bf16",
                ms=time_ms(torch, run, flush),
                kernel_ms=profiled_kernel_ms(torch, run, flush, kern),
                plain_ms=time_ms(torch, plain, flush, reps=10),
                library_ms=(None if library is None
                            else time_ms(torch, library, flush)),
                bound_ms=bms, bound_by=by, max_abs_err=res["max_abs_err"],
                bytes=nbytes)
        main = e["shapes"]["ln768_decode"]
        e.update(launches=sum(launches[wrap].values()),
                 launches_by_path=launches[wrap],
                 max_abs_err=max(s["max_abs_err"]
                                 for s in e["shapes"].values()),
                 ms=main["ms"], plain_ms=main["plain_ms"],
                 bound_ms=main["bound_ms"], bound_by=main["bound_by"],
                 library_ms=main["library_ms"],
                 library=(None if key == "calib" else
                          "torch.nn.functional.layer_norm on a float32 copy"))
        table.append(e)
    e = dict(name="paged_e2softmax_mha_d64", route="cuda",
             source="src/repro_torch/kernels/csrc/paged_e2softmax.cu",
             replaces="src/repro/kernels/flash_e2softmax.py:186", shapes={})
    kw = dict(sole=True, exp_bits=4, int8_scale=L.LOGIT_INT8_SCALE)
    kvmap = KA.default_kv_head_map(12, 12, "cuda")
    for name, res in fk["paged"].items():
        case, causal = res["case"], res["causal"]

        def run():
            return KA.flash_e2softmax_paged(*case, causal=causal, **kw)
        nbytes, flops = attention_work(case, causal, 12, 12, 64)
        bms, by = bound_ms(nbytes, flops, BF16)
        exact_ms, sdpa_ms = paged_exact_vs_sdpa(torch, case, kvmap, flush,
                                                causal)
        e["shapes"][name] = dict(
            shape=f"q {tuple(case[0].shape)} bf16 KV 12 kv_len "
                  f"{case[4][:, 1].tolist()}",
            ms=time_ms(torch, run, flush),
            kernel_ms=profiled_kernel_ms(torch, run, flush, "paged_e2softmax"),
            plain_ms=time_ms(torch, lambda: KA.flash_e2softmax_paged_plain(
                *case, kvmap, causal=causal, **kw), flush, reps=5),
            bound_ms=bms, bound_by=by, max_abs_err=res["max_abs_err"],
            exact_ms=exact_ms, library_ms=sdpa_ms, bytes=nbytes, flops=flops)
    main = e["shapes"]["whisper_decode"]
    e.update(launches=sum(launches["paged_e2softmax_mha_d64"].values()),
             launches_by_path=launches["paged_e2softmax_mha_d64"],
             max_abs_err=max(s["max_abs_err"] for s in e["shapes"].values()),
             ms=main["ms"], plain_ms=main["plain_ms"],
             bound_ms=main["bound_ms"], bound_by=main["bound_by"],
             library_ms=main["library_ms"],
             library="scaled_dot_product_attention (exact, K/V gathered)")
    table.append(e)
    for t in table:
        for s_, v in t["shapes"].items():
            k, lib = v["kernel_ms"], v.get("library_ms")
            log(f"{t['name']} {s_} [{v['shape']}]: {v['ms'] * 1e3:.1f} us "
                f"(profiler: kernel "
                f"{'not measured' if k is None else f'{k * 1e3:.1f} us'}; "
                f"plain {v['plain_ms'] * 1e3:.1f} us; library "
                f"{'none' if lib is None else f'{lib * 1e3:.1f} us'}; bound "
                f"{v['bound_ms'] * 1e3:.3f} us by {v['bound_by']})")
    return table


class EncodeCounter:
    """Counts ``api.encode_paged`` calls (one per admission of an encdec
    request) until :meth:`close`."""

    def __init__(self):
        from repro_torch.models import api
        self._api, self._real = api, api.encode_paged
        self.encodes = 0

        def counted(*a, **kw):
            self.encodes += 1
            return self._real(*a, **kw)
        api.encode_paged = counted

    def close(self):
        self._api.encode_paged = self._real


def whisper_requests(cfg):
    """Eight requests of ``WHISPER_FRAMES`` seeded frames (unit normal, one
    request's 1,500 x 768) and decoder prompts of ``WHISPER_PROMPTS``
    tokens, ``NEW_TOKENS`` new tokens each."""
    import numpy as np
    from repro_torch.serve.engine import Request
    rng = np.random.default_rng(0)
    return [Request(prompt=rng.integers(0, cfg.vocab_size, n).astype(
                        np.int32), max_new_tokens=NEW_TOKENS,
                    frames=rng.standard_normal(
                        (WHISPER_FRAMES, cfg.d_model)).astype(np.float32))
            for n in WHISPER_PROMPTS]


def whisper_engine(cfg, params, blocks=WHISPER_BLOCKS, watermark=1):
    from repro_torch.serve.engine import PagedEngine
    return PagedEngine(cfg, params, num_blocks=blocks, block_size=BLOCK_SIZE,
                       max_seq_len=128, max_running=8,
                       decode_batch=DECODE_BATCH, prefill_chunk=PREFILL_CHUNK,
                       decode_horizon=8, watermark=watermark, device="cuda")


def whisper_trace(torch, cfg, params, label, *, blocks=WHISPER_BLOCKS,
                  watermark=1, loop=False):
    """One trace of ``whisper_requests`` through ``PagedEngine`` (closed,
    or ``loop``: ``AsyncEngine`` with Poisson arrivals at
    ``OPEN_LOOP_RATE``), the counts set to 0 just before and read just
    after: per decoder forward L paged attentions, L cross-attention
    E2Softmax launches and 3L + 1 norms (SOLE: calibrating; exact: the
    exact kernel); per encode L E2Softmax launches and 2L + 1 norms; no
    other kernel of ours. Returns (launches, outputs, summary)."""
    import numpy as np
    from repro_torch.serve.loop import AsyncEngine
    eng = whisper_engine(cfg, params, blocks, watermark)
    reqs = whisper_requests(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counter, encodes = ForwardCounter(), EncodeCounter()
    reset_launches()
    try:
        t0 = time.time()
        if loop:
            lp = AsyncEngine(eng)
            rng = np.random.default_rng(5)
            arrivals = np.cumsum(rng.exponential(1 / OPEN_LOOP_RATE,
                                                 len(reqs))).astype(int)
            handles = [lp.add_request(r, arrival=int(a))
                       for r, a in zip(reqs, arrivals)]
            lp.run()
            outs = [h.tokens for h in handles]
        else:
            outs = eng.generate(reqs)
        torch.cuda.synchronize()
        wall = time.time() - t0
    finally:
        counter.close()
        encodes.close()
    launches = read_launches()
    fwd, enc, n = counter.forwards, encodes.encodes, cfg.n_layers
    exact = cfg.norm_mode == "exact"
    want = {k: 0 for k in launches}
    want["paged_e2softmax"] = n * fwd
    want["e2softmax"] = 0 if exact else n * (fwd + enc)
    want["ailayernorm_exact" if exact else "ailayernorm_calib"] = (
        (3 * n + 1) * fwd + (2 * n + 1) * enc)
    if fwd <= 0 or enc < len(reqs) or launches != want:
        raise AssertionError(f"[{label}] launches {launches} over {fwd} "
                             f"forwards and {enc} encodes, expected {want}")
    if [len(o) for o in outs] != [NEW_TOKENS] * len(reqs):
        raise AssertionError(f"[{label}] token counts")
    st = eng.stats()
    eng.cache.check_refcounts()
    if st["blocks_in_use"] or eng.cache._cross_tables:
        raise AssertionError(f"[{label}] pages leaked: {st}")
    summary = {"wall_s": wall, "forwards": fwd, "encodes": enc,
               "preemptions": st["preemptions"],
               "peak_blocks_in_use": st["peak_blocks_in_use"],
               "max_memory_allocated_gib":
                   torch.cuda.max_memory_allocated() / 2 ** 30}
    if loop:
        ls = lp.stats()
        summary.update(ttft_steps=ls["ttft_steps"], itl_steps=ls["itl_steps"],
                       ttft_ms=ls["ttft_ms"])
    log(f"[{label}] {len(reqs)} requests of {WHISPER_FRAMES} frames, "
        f"{sum(len(o) for o in outs)} tokens in {wall:.3f} s; {fwd} decoder "
        f"forwards, {enc} encodes; launches {json.dumps(launches)}; "
        + json.dumps({k: v for k, v in summary.items() if k != "wall_s"}))
    return launches, outs, summary


def whisper_oracle(torch, cfg, params, reqs):
    """The port's dense-cache oracle on the card: per request ``prefill``
    of its frames and prompt, then greedy ``decode_step``s."""
    from repro_torch.models import api
    outs = []
    for r in reqs:
        plen = len(r.prompt)
        batch = {"frames": torch.tensor(r.frames, device="cuda")[None],
                 "tokens": torch.tensor(r.prompt, device="cuda")[None]}
        logits, cache = api.prefill(params, batch, cfg,
                                    plen + r.max_new_tokens)
        out = [int(logits[0, -1, :cfg.vocab_size].argmax())]
        for i in range(1, r.max_new_tokens):
            logits, cache = api.decode_step(
                params, cache, torch.tensor([out[-1]], dtype=torch.int32,
                                            device="cuda"), plen + i - 1, cfg)
            out.append(int(logits[0, :cfg.vocab_size].argmax()))
        outs.append(out)
    return outs


def tokens_equal(a, b, label):
    if a != b:
        diff = [(i, next(j for j, (x, y) in enumerate(zip(p, q)) if x != y))
                for i, (p, q) in enumerate(zip(a, b)) if p != q]
        raise AssertionError(f"[{label}] tokens part: (request, first "
                             f"token) {diff}")


def profile_whisper(torch, cfg, params):
    """One SOLE wave of ``whisper_requests`` under ``torch.profiler``:
    wall, device busy and its share, device kernels per decoder forward,
    and the encoder's share of busy, from one encode's device time (CUDA
    events over ``api.encode_paged`` of one request) times the wave's
    encodes."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import api
    eng = whisper_engine(cfg, params)
    reqs = whisper_requests(cfg)
    eng.generate(reqs[:1])                       # warm the allocator
    torch.cuda.synchronize()
    counter, encodes = ForwardCounter(), EncodeCounter()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            eng.generate(reqs)
            torch.cuda.synchronize()
            wall = time.time() - t0
    finally:
        counter.close()
        encodes.close()
    rows = device_rows(torch, prof)
    busy = sum(r[0] for r in rows) / 1e6
    kernels = sum(n for _, n, _ in rows)
    frames = torch.tensor(reqs[0].frames, device="cuda")[None]
    row = torch.tensor(eng.cache.batch_cross([None], 94), device="cuda")
    state = eng._state()
    start, end = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
    api.encode_paged(eng.params, frames, row, state, cfg)
    torch.cuda.synchronize()
    start.record()
    for _ in range(5):
        api.encode_paged(eng.params, frames, row, state, cfg)
    end.record()
    torch.cuda.synchronize()
    enc_ms = start.elapsed_time(end) / 5
    enc_share = encodes.encodes * enc_ms / 1e3 / busy
    out = {"wall_s": wall, "device_busy_s": busy,
           "busy_share_of_wall": busy / wall, "kernels": kernels,
           "forwards": counter.forwards, "encodes": encodes.encodes,
           "kernels_per_forward": kernels / max(counter.forwards, 1),
           "encode_ms": enc_ms, "encoder_share_of_busy": enc_share,
           "decoder_share_of_busy": 1 - enc_share,
           "top": [{"ms": us / 1e3, "count": n, "kernel": key[:100]}
                   for us, n, key in rows[:10]]}
    log(f"[whisper paged] profiled wave: wall {wall:.3f} s, device busy "
        f"{busy:.3f} s ({busy / wall:.3f} of wall), {kernels} kernels over "
        f"{counter.forwards} decoder forwards and {encodes.encodes} encodes; "
        f"one encode {enc_ms:.2f} ms on the device: encoder "
        f"{enc_share:.3f} of busy, decoder {1 - enc_share:.3f}")
    for us, n, key in rows[:10]:
        log(f"  {us / 1e3:9.2f} ms {n:7d} x  {key[:100]}")
    return out


def serve_whisper(torch):
    """Phase 4 for encdec: whisper_small at full width and depth (12 + 12
    layers, d 768, random weights from a seed) through ``PagedEngine``,
    the counts read around each trace: SOLE bf16 (the main path); exact
    float32, tokens equal to the port's dense-cache oracle on the card;
    exact float32 in a tight pool (preempts and re-encodes) with tokens
    equal to the roomy run; exact float32 through ``AsyncEngine`` with
    Poisson arrivals, tokens equal to the closed run; a profiled SOLE
    wave. Returns (launches of the SOLE and of the roomy exact trace,
    summaries)."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import api
    cfg = get_config("whisper_small")
    t0 = time.time()
    params = api.init_params(0, cfg, "cuda")
    torch.cuda.synchronize()
    log(f"[whisper] init_params bf16: {time.time() - t0:.2f} s")
    launches, _, sole = whisper_trace(torch, cfg, params, "whisper sole bf16")
    prof = profile_whisper(torch, cfg, params)
    del params
    exact = dataclasses.replace(cfg, softmax_mode="exact", norm_mode="exact",
                                logit_int8=False, dtype="float32")
    params = api.init_params(0, exact, "cuda")
    xlaunches, roomy, ex = whisper_trace(torch, exact, params,
                                         "whisper exact f32")
    tokens_equal(roomy, whisper_oracle(torch, exact, params,
                                       whisper_requests(exact)),
                 "whisper exact f32: paged vs dense oracle")
    _, tight, ts = whisper_trace(torch, exact, params,
                                 "whisper exact f32 tight",
                                 blocks=WHISPER_TIGHT_BLOCKS, watermark=0)
    if not ts["preemptions"] or ts["encodes"] <= len(WHISPER_PROMPTS):
        raise AssertionError(f"whisper tight pool: no re-encode ({ts})")
    tokens_equal(tight, roomy, "whisper exact f32: tight vs roomy")
    _, looped, ls = whisper_trace(torch, exact, params,
                                  "whisper exact f32 open loop", loop=True)
    tokens_equal(looped, roomy, "whisper exact f32: open loop vs closed")
    del params
    torch.cuda.empty_cache()
    log("[whisper] exact f32: paged tokens equal the dense oracle's, the "
        "tight pool's (re-encoded) and the open loop's")
    return {"sole": launches, "exact": xlaunches}, {
        "sole": sole, "exact": ex, "tight": ts, "open_loop": ls,
        "profile": prof}


def vlm_prompt(torch, params, cfg, seed=0):
    """``VLM_LANES`` lanes of ``VLM_PROMPT`` embeds: a 16 x 16 patch grid
    (token rows perturbed: temporal 0, height and width the patch's row
    and column) at flat positions 0-255, then text whose three ids are its
    flat position, as the decode step's are. Returns (batch, text ids)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (VLM_LANES, VLM_PROMPT),
                         generator=gen, device="cuda")
    emb = params["embed"]["table"][toks].clone()
    n = VLM_GRID * VLM_GRID
    emb[:, :n] += (0.02 * torch.randn((VLM_LANES, n, cfg.d_model),
                                      generator=gen, device="cuda")
                   ).to(emb.dtype)
    pos = torch.arange(VLM_PROMPT, dtype=torch.int32, device="cuda")
    pos = pos.expand(3, VLM_LANES, VLM_PROMPT).clone()
    grid = torch.arange(n, dtype=torch.int32, device="cuda")
    pos[0, :, :n] = 0
    pos[1, :, :n] = grid // VLM_GRID
    pos[2, :, :n] = grid % VLM_GRID
    return {"embeds": emb, "positions": pos}, toks


def vlm_run(torch, cfg, params, label):
    """``api.prefill`` of the prompt into a cache of ``VLM_PROMPT +
    NEW_TOKENS`` columns, then ``NEW_TOKENS`` greedy ``decode_step``s, the
    counts set to 0 just before and read just after (per call 28
    E2Softmax launches in SOLE mode, 57 norms: calibrating or exact).
    Returns (launches, prompt batch, decoded tokens, logits per call,
    summary)."""
    from repro_torch.models import api
    batch, _ = vlm_prompt(torch, params, cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.time()
    logits, cache = api.prefill(params, batch, cfg, VLM_PROMPT + NEW_TOKENS)
    torch.cuda.synchronize()
    t_pre = time.time() - t0
    rows = [logits[:, 0].float()]
    toks = []
    t0 = time.time()
    for i in range(NEW_TOKENS):
        tok = rows[-1][:, :cfg.vocab_size].argmax(-1).to(torch.int32)
        toks.append(tok)
        logits, cache = api.decode_step(params, cache, tok, VLM_PROMPT + i,
                                        cfg)
        rows.append(logits.float())
    torch.cuda.synchronize()
    t_dec = (time.time() - t0) / NEW_TOKENS
    launches = read_launches()
    calls = 1 + NEW_TOKENS
    exact = cfg.norm_mode == "exact"
    want = {k: 0 for k in launches}
    want["e2softmax"] = 0 if exact else cfg.n_layers * calls
    want["ailayernorm_exact" if exact else "ailayernorm_calib"] = (
        (2 * cfg.n_layers + 1) * calls)
    if launches != want:
        raise AssertionError(f"[{label}] launches {launches}, expected {want}")
    if not all(torch.isfinite(r).all() for r in rows):
        raise AssertionError(f"[{label}] non-finite logits")
    summary = {"prefill_s": t_pre, "decode_step_s": t_dec,
               "max_memory_allocated_gib":
                   torch.cuda.max_memory_allocated() / 2 ** 30}
    log(f"[{label}] prefill of {VLM_LANES} x {VLM_PROMPT} embeds "
        f"{t_pre:.3f} s, {NEW_TOKENS} decode steps at {t_dec * 1e3:.1f} ms; "
        f"launches per call {json.dumps({k: v / calls for k, v in launches.items() if v})}; "
        f"peak {summary['max_memory_allocated_gib']:.2f} GiB")
    return launches, batch, torch.stack(toks, 1), rows, summary


def serve_vlm(torch):
    """Phase 4 for vlm: qwen2_vl_7b at full width and depth (28 layers,
    random weights from a seed): :func:`vlm_run` in SOLE bf16 (the main
    path), then in exact float32 with the prefill and decode logits held
    to ``forward`` over the prompt and the decoded tokens (2e-3, the bar
    of the reference's ``tests/test_parity.py``). Returns (launches of the
    SOLE and of the exact run, summaries)."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import api
    cfg = get_config("qwen2_vl_7b")
    t0 = time.time()
    params = api.init_params(0, cfg, "cuda")
    torch.cuda.synchronize()
    log(f"[vlm] init_params bf16: {time.time() - t0:.2f} s, "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated")
    launches, _, _, _, sole = vlm_run(torch, cfg, params, "vlm sole bf16")
    del params
    torch.cuda.empty_cache()
    exact = dataclasses.replace(cfg, softmax_mode="exact", norm_mode="exact",
                                logit_int8=False, dtype="float32")
    params = api.init_params(0, exact, "cuda")
    xlaunches, batch, toks, rows, ex = vlm_run(torch, exact, params,
                                               "vlm exact f32")
    emb = torch.cat([batch["embeds"],
                     params["embed"]["table"][toks.long()]], 1)
    n = VLM_PROMPT + NEW_TOKENS
    flat = torch.arange(VLM_PROMPT, n, dtype=torch.int32, device="cuda")
    pos = torch.cat([batch["positions"],
                     flat.expand(3, VLM_LANES, NEW_TOKENS)], 2)
    with torch.no_grad():
        full = api.forward(params, {"embeds": emb, "positions": pos}, exact)
    errs = [(rows[i] - full[:, VLM_PROMPT - 1 + i]).abs().max().item()
            for i in range(NEW_TOKENS + 1)]
    ex["max_abs_err_vs_forward"] = max(errs)
    log(f"[vlm exact f32] prefill + {NEW_TOKENS} decode logits against "
        f"forward over {n} positions: max |err| {max(errs):.3e} (prefill "
        f"{errs[0]:.3e})")
    if max(errs) > 2e-3:
        raise AssertionError(f"vlm prefill/decode vs forward: {max(errs)}")
    del params, full
    torch.cuda.empty_cache()
    return {"sole": launches, "exact": xlaunches}, {"sole": sole,
                                                    "exact": ex}


def small_family_parity(torch):
    """The smoke whisper engine (``PagedEngine``; float32) and the smoke
    qwen2-vl ``prefill`` + ``decode_step`` on the card against the same
    on the CPU: exact mode tokens equal, SOLE at least 95%."""
    import numpy as np
    from repro_torch.configs.base import get_config
    from repro_torch.models import api
    from repro_torch.models.state import tree_map
    from repro_torch.serve.engine import PagedEngine, Request
    exact = dict(softmax_mode="exact", norm_mode="exact", logit_int8=False)
    for mode, change, bar in (("exact", exact, 1.0), ("sole", {}, 0.95)):
        cfg = dataclasses.replace(get_config("whisper_small").smoke(),
                                  **change)
        params = api.init_params(0, cfg, "cpu")
        rng = np.random.default_rng(1)
        reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, n).astype(
                            np.int32), max_new_tokens=8,
                        frames=rng.standard_normal((m, cfg.d_model)).astype(
                            np.float32))
                for n, m in ((5, 32), (20, 17), (12, 40), (9, 8), (3, 32))]
        outs = []
        for dev in ("cpu", "cuda"):
            eng = PagedEngine(cfg, params, num_blocks=64, block_size=8,
                              max_seq_len=64, decode_batch=4,
                              prefill_chunk=8, device=dev)
            outs.append(eng.generate(reqs))
            eng.cache.check_refcounts()
        check_agreement(outs, f"whisper_small paged {mode}", bar)
        cfg = dataclasses.replace(get_config("qwen2_vl_7b").smoke(), **change)
        params = api.init_params(0, cfg, "cpu")
        outs = []
        for dev in ("cpu", "cuda"):
            p = tree_map(lambda t: t.to(dev), params)
            gen = torch.Generator().manual_seed(3)
            toks = torch.randint(0, cfg.vocab_size, (4, 24), generator=gen)
            emb = params["embed"]["table"][toks]
            pos = torch.arange(24, dtype=torch.int32).expand(3, 4, 24)
            logits, cache = api.prefill(
                p, {"embeds": emb.to(dev), "positions": pos.to(dev)}, cfg, 32)
            out = [logits[:, 0, :cfg.vocab_size].argmax(-1).to(torch.int32)]
            for i in range(7):
                logits, cache = api.decode_step(p, cache, out[-1], 24 + i,
                                                cfg)
                out.append(logits[:, :cfg.vocab_size].argmax(-1).to(
                    torch.int32))
            outs.append(torch.stack(out, 1).cpu().tolist())
        check_agreement(outs, f"qwen2_vl_7b prefill/decode {mode}", bar)


def serve_families(torch):
    """The encdec and vlm phases, timed: kernel checks at their shapes,
    whisper_small and qwen2_vl_7b at full width, the smoke models on the
    card against the CPU. Returns (kernel checks, launches by new table
    row, summaries)."""
    t0 = time.time()
    fk = check_family_kernels(torch)
    log(f"[phase time] encdec/vlm kernel checks: {time.time() - t0:.1f} s")
    t0 = time.time()
    wl, wsum = serve_whisper(torch)
    log(f"[phase time] whisper_small paths: {time.time() - t0:.1f} s")
    t0 = time.time()
    vl, vsum = serve_vlm(torch)
    log(f"[phase time] qwen2_vl_7b paths: {time.time() - t0:.1f} s")
    t0 = time.time()
    small_family_parity(torch)
    log(f"[phase time] encdec/vlm smoke card vs cpu: {time.time() - t0:.1f} s")
    # launches: the SOLE paths' (the main paths), the exact norm's from
    # the exact runs (it runs in exact mode only)
    launches = {}
    for row, kern, mode in (
            ("e2softmax_encdec_vlm", "e2softmax", "sole"),
            ("ailayernorm_calib_encdec_vlm", "ailayernorm_calib", "sole"),
            ("ailayernorm_exact_encdec_vlm", "ailayernorm_exact", "exact"),
            ("paged_e2softmax_mha_d64", "paged_e2softmax", "sole")):
        launches[row] = {"whisper": wl[mode][kern], "vlm": vl[mode][kern]}
    return fk, launches, {"whisper": wsum, "vlm": vsum}


# -- training (qwen2_0_5b at full width; the exact norm's backward kernel) -----

# the backward kernel's shapes: (name, rows, C, rms, groups)
NORM_BWD_CASES = (
    ("rms896", (8, 2048, 8192), 896, True, 1),
    ("ln2048", (8, 2048), 2048, False, 1),
    ("ln768", (8, 1500), 768, False, 1),
    ("rms3584", (8, 2048), 3584, True, 1),
    ("ln4096", (8, 2400), 4096, False, 1),
    ("ln6144", (8, 2400), 6144, False, 1),
    ("groupnorm", (512, 8192), 64, False, 64))
TRAIN_SEQ = 1024                   # train_4k's 4,096 cut for one card and time
TRAIN_BATCH = 8                    # train_4k's 256 cut likewise
TRAIN_STEPS = 20
TRAIN_CKPT_AT = 10
TRAIN_LR = 3e-4
GRAD_NORM_RTOL = 1e-3              # kernels against the reference route
GRAD_COSINE_MIN = 0.999


def _bwd_inputs(torch, gen, rows, c, rms, groups, dtype):
    lead = (groups, c) if groups > 1 else (c,)
    x = (torch.randn((rows, c), generator=gen, device="cuda") * 3
         + torch.randn((rows, 1), generator=gen, device="cuda")).to(dtype)
    dy = torch.randn((rows, c), generator=gen, device="cuda").to(dtype)
    g = 1 + 0.1 * torch.randn(lead, generator=gen, device="cuda")
    b = None if rms else 0.1 * torch.randn(lead, generator=gen,
                                           device="cuda")
    return x, dy, g, b


def _bf16_ulp(torch, v):
    """One bf16 ulp at |v| (the spacing of bf16 values there)."""
    a = v.float().abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def check_norm_backward(torch):
    """The exact norm's backward kernel (``exact_norm_bwd_kernel`` +
    ``exact_norm_wgrad_kernel``) against autograd of its plain version on
    the card at every ``NORM_BWD_CASES`` shape, float32 and bf16 rows (dy
    in the rows' type): dx within 2e-6 of the row's scale (max |inv * g *
    dy| over the row) in float32, within one bf16 ulp of the plain value
    (or that bar) in bf16; dgamma/dbeta within 1e-5 of their largest
    magnitude; a second call bitwise equal; the first 8 rows' dx (and a
    (64, 64) GroupNorm's first 64) bitwise equal to a call on those rows
    alone."""
    from repro_torch.kernels import ailayernorm as KN
    gen = torch.Generator(device="cuda").manual_seed(24)
    res = {}
    for name, row_counts, c, rms, groups in NORM_BWD_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            for rows in row_counts:
                x, dy, g, b = _bwd_inputs(torch, gen, rows, c, rms, groups,
                                          dtype)
                eps = 1e-6 if rms else 1e-5
                dx, dg, db = KN.exact_norm_backward(x, g, b, dy, rms=rms,
                                                    eps=eps)
                dx2, dg2, db2 = KN.exact_norm_backward(x, g, b, dy, rms=rms,
                                                       eps=eps)
                same = (torch.equal(dx, dx2) and torch.equal(dg, dg2)
                        and (rms or torch.equal(db, db2)))
                head = max(8, groups)
                dxh = KN.exact_norm_backward(x[:head].contiguous(), g, b,
                                             dy[:head].contiguous(), rms=rms,
                                             eps=eps)[0]
                stable = torch.equal(dxh, dx[:head])
                px, pg, pb = KN.exact_norm_backward_plain(x, g, b, dy,
                                                          rms=rms, eps=eps)
                xf = KN.grouped_rows(x.float(), g).reshape(rows, c)
                gg = g.reshape(-1, c).repeat(rows // groups, 1) \
                    if groups > 1 else g
                mu = 0 if rms else xf.mean(-1, keepdim=True)
                var = torch.square(xf - mu).mean(-1, keepdim=True)
                inv = torch.rsqrt(var + eps)
                scale = (inv * gg * dy.float()).abs().amax(-1, keepdim=True)
                err = (dx.float() - px.float()).abs()
                bar = 2e-6 * scale
                if dtype == torch.bfloat16:
                    bar = torch.maximum(bar, _bf16_ulp(torch, px))
                dx_ok = bool((err <= bar).all())
                dx_rel = (err / scale.clamp_min(1e-30)).max().item()
                g_err = ((dg - pg).abs().max() / pg.abs().max()).item()
                b_err = 0.0 if rms else (
                    (db - pb).abs().max() / pb.abs().max()).item()
                key = f"{name}_{'bf16' if dtype == torch.bfloat16 else 'f32'}_rows{rows}"
                log(f"ailayernorm_exact_bwd {key}: dx max |err| / row scale "
                    f"{dx_rel:.3e} ({'within' if dx_ok else 'OUTSIDE'} the "
                    f"bar), dgamma {g_err:.3e}, dbeta {b_err:.3e} of their "
                    f"max; two calls bitwise {same}; first {head} rows "
                    f"alone bitwise {stable}")
                if not (dx_ok and same and stable and g_err <= 1e-5
                        and b_err <= 1e-5):
                    raise AssertionError(f"norm backward {key} fails")
                res[key] = dict(x=x, dy=dy, g=g, b=b, rms=rms, eps=eps,
                                max_rel_err=max(dx_rel, g_err, b_err))
    return res


BWD_KERNELS = ("exact_norm_bwd_kernel", "exact_norm_wgrad_kernel")


def bwd_device_kernels(torch, run, key):
    """One backward call is its two kernels on the device and no other
    (no fill, no cast): two launches a call by the wrapper's counter and
    no other kernel under ``torch.profiler``. Up to five windows, until
    one keeps a record of ours: the profiler can keep none in a window,
    and in runs of windows (3 in a row at one shape once, while every
    other shape of that sweep kept all 10), so a shape's own windows may
    keep none; ``time_norm_backward`` holds the sweep to records of both
    kernels. Returns (kernels per call, records of ours kept of 10)."""
    from repro_torch.kernels import ailayernorm as KN
    for _ in range(5):
        n, others, seen = device_kernels(
            torch, run, wrappers=(KN.exact_norm_backward,),
            ours=lambda k: any(s in k for s in BWD_KERNELS))
        if seen:
            break
    if n != 2 or others:
        raise AssertionError(f"norm backward {key}: {n} device kernels per "
                             f"call, others {others}, {seen} records of "
                             "its kernels")
    return n, seen


def time_norm_backward(torch, cases, launches):
    """The backward kernel (one call: its two launches, checked as the
    only device kernels of a call) by CUDA events with L2 flushed, beside autograd of its plain version and of one
    PyTorch call of the same function on the same float32 rows
    (``F.rms_norm``/``F.layer_norm``; ``F.group_norm`` with 64 groups for
    the per-head affine), each timed as the backward alone on a graph
    kept for it. Bound: x and dy read, dx written (the rows' type), gamma
    read and dgamma (dbeta) written in float32."""
    import torch.nn.functional as F
    from repro_torch.kernels import ailayernorm as KN
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda").zero_
    e = dict(name="ailayernorm_exact_bwd", route="cuda",
             source="src/repro_torch/kernels/csrc/ailayernorm.cu",
             replaces="src/repro/train/trainer.py:56 (jax.value_and_grad "
                      "through XLA's exact norms, repro/ops/reference.py:57, "
                      "65: no pallas_call)",
             shapes={})
    for key, r in cases.items():
        x, dy, g, b, rms, eps = (r[k] for k in ("x", "dy", "g", "b", "rms",
                                                "eps"))
        rows, c = x.shape
        groups = g.shape[0] if g.ndim == 2 else 1

        def run():
            return KN.exact_norm_backward(x, g, b, dy, rms=rms, eps=eps)

        def graph(fn_out, ins):
            return lambda: torch.autograd.grad(fn_out, ins, dyf,
                                               retain_graph=True)
        dyf = dy.float()
        xs = x.detach().float().requires_grad_(True)
        gs = g.detach().requires_grad_(True)
        bs = None if rms else b.detach().requires_grad_(True)
        ins = (xs, gs) if rms else (xs, gs, bs)
        plain = graph(KN.exact_norm_plain(xs, gs, bs, rms=rms, eps=eps), ins)
        if groups > 1:
            lib_out = F.group_norm(xs.reshape(-1, groups * c), groups,
                                   gs.reshape(-1), bs.reshape(-1),
                                   eps).reshape(rows, c)
        elif rms:
            lib_out = (F.rms_norm(xs, (c,), gs, eps)
                       if hasattr(F, "rms_norm") else None)
        else:
            lib_out = F.layer_norm(xs, (c,), gs, bs, eps)
        library = None if lib_out is None else graph(lib_out, ins)
        nbytes = (3 * rows * c * x.element_size()
                  + g.numel() * 4 * (2 if rms else 3))
        bms, by = bound_ms(nbytes, 14 * rows * c, FP32)
        n_dev, kept = bwd_device_kernels(torch, run, key)
        e["shapes"][key] = dict(
            shape=f"rows {rows} C {c} {'rms' if rms else 'ln'}"
                  f"{f' ({groups}, {c}) affine' if groups > 1 else ''} "
                  f"{x.dtype}".replace("torch.", ""),
            ms=time_ms(torch, run, flush),
            kernel_ms=profiled_kernel_ms(torch, run, flush,
                                         "exact_norm_bwd_kernel"),
            wgrad_ms=profiled_kernel_ms(torch, run, flush,
                                        "exact_norm_wgrad_kernel"),
            device_kernels=n_dev, records_kept=kept,
            plain_ms=time_ms(torch, plain, flush, reps=10),
            library_ms=(None if library is None
                        else time_ms(torch, library, flush, reps=10)),
            bound_ms=bms, bound_by=by, bytes=nbytes,
            max_rel_err=r["max_rel_err"])
    if not any(v["records_kept"] == 10 for v in e["shapes"].values()):
        raise AssertionError("norm backward: the profiler kept all 10 "
                             "records of the two kernels at no shape")
    main = e["shapes"]["rms896_bf16_rows8192"]
    e.update(launches=launches["fwd_bwd"]["ailayernorm_exact_bwd"],
             launches_from=f"qwen2_0_5b full-width Trainer run, "
                           f"{TRAIN_STEPS} steps",
             max_abs_err=max(r["max_rel_err"] for r in cases.values()),
             max_abs_err_is="largest dx error over its row's scale, or "
                            "dgamma/dbeta error over their max",
             ms=main["ms"], plain_ms=main["plain_ms"],
             bound_ms=main["bound_ms"], bound_by=main["bound_by"],
             library_ms=main["library_ms"],
             library="autograd of torch.nn.functional.rms_norm on float32 "
                     "rows (backward only)")
    for s_, v in e["shapes"].items():
        k, w, lib = v["kernel_ms"], v["wgrad_ms"], v["library_ms"]
        log(f"ailayernorm_exact_bwd {s_} [{v['shape']}]: {v['ms'] * 1e3:.1f} "
            f"us (profiler: {v['device_kernels']:.0f} device kernels a call, "
            f"{v['records_kept']} of their 10 records kept; dx kernel "
            f"{'not measured' if k is None else f'{k * 1e3:.1f} us'}, wgrad "
            f"kernel {'not measured' if w is None else f'{w * 1e3:.1f} us'}; "
            f"plain "
            f"autograd {v['plain_ms'] * 1e3:.1f} us; library autograd "
            f"{'none' if lib is None else f'{lib * 1e3:.1f} us'}; bound "
            f"{v['bound_ms'] * 1e3:.2f} us by {v['bound_by']})")
    return e


def _grad_launches(torch, masters, batch, cfg):
    """One train step's gradients through ``trainer.loss_and_grads``'s
    pieces with the exact norm's counts read between them: (loss, grads,
    {"forward", "recompute", "backward"} launches)."""
    from repro_torch.convert import serving_view
    from repro_torch.kernels import ailayernorm as KN
    from repro_torch.models import api
    from repro_torch.train.optimizer import _leaves, _unflatten_like
    leaves = [p.detach().requires_grad_(True) for p in _leaves(masters)]
    KN.exact_norm.launches = KN.exact_norm_backward.launches = 0
    loss, _ = api.loss_fn(serving_view(_unflatten_like(masters, leaves), cfg),
                          batch, cfg)
    fwd = KN.exact_norm.launches
    grads = torch.autograd.grad(loss, leaves)
    torch.cuda.synchronize()
    counts = {"forward": fwd, "recompute": KN.exact_norm.launches - fwd,
              "backward": KN.exact_norm_backward.launches}
    return loss.item(), grads, counts


def train_full_width(torch, workdir):
    """qwen2_0_5b at full width and depth (24 layers, d 896, 14/2 heads,
    vocab 151,936): float32 masters, bf16 compute, remat ``dots``, AdamW,
    batch 8 x 1,024 tokens of the affine task (train_4k's 256 x 4,096 cut
    for one card and the time limit).

    Step 0's gradients through the kernels against the same step with
    ``ops_backend="reference"`` (the plain norms) on the card: grad norm
    within 1e-3, every leaf's cosine >= 0.999; the exact norm's launches
    per forward (2L + 1), per backward (2(2L + 1): two kernels a call) and
    what remat recomputes (the layers' 2L). Then the ``Trainer`` (the user's entry point) for 20
    steps with its counts set to 0 just before and read just after, a
    checkpoint at step 10 (the step-20 one too); loss falling (mean of the
    last five below the first five's), no NaN; then a second ``Trainer``
    restored from step 10 and run to 20: masters bitwise the first run's,
    else the first differing leaf is printed and the check fails; one
    profiled step's device time in the norm kernels."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.base import SHAPES, ShapeConfig, get_config
    from repro_torch.data.pipeline import make_batch
    from repro_torch.train.optimizer import OptConfig, _leaves
    from repro_torch.train.trainer import Trainer, batch_to_device
    cfg = get_config("qwen2_0_5b")
    full = SHAPES["train_4k"]
    shape = ShapeConfig("train_1k_b8", TRAIN_SEQ, TRAIN_BATCH, "train")
    reduced = {"global_batch": f"{full.global_batch} -> {TRAIN_BATCH}",
               "seq_len": f"{full.seq_len} -> {TRAIN_SEQ}"}
    log(f"[train] {cfg.name} full width and depth ({cfg.n_layers} layers, "
        f"d {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, vocab "
        f"{cfg.vocab_size}), remat {cfg.remat}, bf16 compute over float32 "
        f"masters; reduced from train_4k: {json.dumps(reduced)}")
    opt = OptConfig(lr=TRAIN_LR, warmup_steps=TRAIN_STEPS // 10 + 1,
                    total_steps=TRAIN_STEPS)
    ckdir = os.path.join(workdir, "qwen2_full")
    shutil.rmtree(ckdir, ignore_errors=True)
    tr = Trainer(cfg, shape, opt, device="cuda", ckpt_dir=ckdir,
                 ckpt_every=TRAIN_CKPT_AT)
    n_params = sum(p.numel() for p in _leaves(tr.params))
    batch = batch_to_device(make_batch(cfg, shape, 0), "cuda")
    nl = 2 * cfg.n_layers + 1
    torch.cuda.reset_peak_memory_stats()
    loss_k, grads_k, counts = _grad_launches(torch, tr.params, batch, cfg)
    peak_step = torch.cuda.max_memory_allocated() / 2 ** 30
    ref_cfg = dataclasses.replace(cfg, ops_backend="reference")
    loss_r, grads_r, counts_r = _grad_launches(torch, tr.params, batch,
                                               ref_cfg)
    gn_k = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads_k)).item()
    gn_r = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads_r)).item()
    cos = [torch.nn.functional.cosine_similarity(
        a.flatten().double(), b.flatten().double(), dim=0).item()
        for a, b in zip(grads_k, grads_r)]
    del grads_k, grads_r
    log(f"[train] step 0 through the kernels: loss {loss_k:.6f}, grad norm "
        f"{gn_k:.6f}; reference route: loss {loss_r:.6f}, grad norm "
        f"{gn_r:.6f} (rel {abs(gn_k - gn_r) / gn_r:.2e}); min leaf cosine "
        f"{min(cos):.6f}; exact-norm launches {json.dumps(counts)} "
        f"(reference route {json.dumps(counts_r)}); peak {peak_step:.2f} GiB")
    if abs(gn_k - gn_r) > GRAD_NORM_RTOL * gn_r or min(cos) < GRAD_COSINE_MIN:
        raise AssertionError("train step 0: kernels and reference route "
                             "part")
    if counts["forward"] != nl or counts["backward"] != 2 * nl:
        raise AssertionError(f"train step 0: exact-norm launches {counts}, "
                             f"expected {nl} forward and {2 * nl} backward "
                             "(two kernels a call)")
    if counts_r != {"forward": 0, "recompute": 0, "backward": 0}:
        raise AssertionError(f"reference route launched {counts_r}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.time()
    out = tr.run(TRAIN_STEPS)
    torch.cuda.synchronize()
    wall = time.time() - t0
    fwd_bwd = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [m["loss"] for m in out["metrics"]]
    times = [m["step_time"] for m in out["metrics"]]
    step_s = float(np.median(times[1:]))
    want_fwd = TRAIN_STEPS * (counts["forward"] + counts["recompute"])
    want = {k: 0 for k in fwd_bwd}
    want.update(ailayernorm_exact=want_fwd,
                ailayernorm_exact_bwd=TRAIN_STEPS * 2 * nl)
    log(f"[train] Trainer: {TRAIN_STEPS} steps in {wall:.2f} s (median step "
        f"{step_s:.3f} s, {TRAIN_BATCH * TRAIN_SEQ / step_s:.0f} tokens/s); "
        f"losses {', '.join(f'{v:.4f}' for v in losses)}; peak "
        f"{peak:.2f} GiB; launches {json.dumps({k: v for k, v in fwd_bwd.items() if v})}")
    if fwd_bwd != want:
        raise AssertionError(f"Trainer launches {fwd_bwd}, expected {want}")
    if not all(np.isfinite(losses)):
        raise AssertionError("non-finite train loss")
    if not np.mean(losses[-5:]) < np.mean(losses[:5]):
        raise AssertionError(f"loss did not fall: {losses}")
    size = sum(os.path.getsize(os.path.join(ckdir, f"step-{TRAIN_CKPT_AT}", f))
               for f in os.listdir(os.path.join(ckdir,
                                                f"step-{TRAIN_CKPT_AT}")))
    saves = dict(tr.saver.times)
    ref = [p.clone() for p in _leaves(tr.params)]
    del tr, out
    torch.cuda.empty_cache()
    tr2 = Trainer(cfg, shape, opt, device="cuda", ckpt_dir=ckdir)
    t0 = time.time()
    tr2.restore(step=TRAIN_CKPT_AT)
    torch.cuda.synchronize()
    t_restore = time.time() - t0
    tr2.saver = None
    tr2.run(TRAIN_STEPS)
    got = _leaves(tr2.params)
    diff = [i for i, (a, b) in enumerate(zip(ref, got))
            if not torch.equal(a, b)]
    log(f"[train] checkpoint at step {TRAIN_CKPT_AT}: {size / 2 ** 30:.2f} "
        f"GiB ({n_params:,} parameters, masters + moments); saves (host "
        f"snapshot s, write s) by step {json.dumps(saves)}; restore "
        f"{t_restore:.2f} s; resumed to step "
        f"{TRAIN_STEPS}: {len(got) - len(diff)}/{len(got)} leaves bitwise "
        f"equal to the uninterrupted run"
        + (f"; first differing leaf {diff[0]}" if diff else ""))
    if diff:
        raise AssertionError(f"resume differs from the uninterrupted run at "
                             f"leaf {diff[0]}")
    # one profiled step: the norm kernels' share of device time
    step_fn = tr2.step_fn
    b = batch_to_device(make_batch(cfg, shape, TRAIN_STEPS), "cuda")
    step_fn(tr2.params, tr2.opt_state, b)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step_fn(tr2.params, tr2.opt_state, b)
        torch.cuda.synchronize()
    rows = [(e.key, _device_us(e), e.count) for e in prof.key_averages()]
    busy = sum(us for _, us, _ in rows)
    norm_us = sum(us for k, us, _ in rows if "exact_norm" in k)
    top = sorted(rows, key=lambda r: -r[1])[:6]
    share = norm_us / busy if busy else None
    log(f"[train] profiled step: device busy {busy / 1e3:.1f} ms, the exact "
        f"norm kernels {norm_us / 1e3:.2f} ms "
        f"({'not measured' if share is None else f'{share:.4f}'} of busy); "
        f"top kernels {json.dumps([(k[:60], round(us / 1e3, 2), n) for k, us, n in top])}")
    shutil.rmtree(ckdir, ignore_errors=True)
    del tr2, ref, got
    torch.cuda.empty_cache()
    return {"launches": {"step0": counts, "fwd_bwd": fwd_bwd},
            "summary": dict(
                arch=cfg.name, reduced=reduced, steps=TRAIN_STEPS,
                losses=losses, step_s=step_s,
                tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / step_s,
                peak_gib=peak, peak_step0_gib=peak_step, params=n_params,
                grad_norm=gn_k, grad_norm_reference=gn_r,
                min_leaf_cosine=min(cos), ckpt_gib=size / 2 ** 30,
                ckpt_saves_s=saves, ckpt_restore_s=t_restore,
                resume_bitwise=not diff, profiled_busy_ms=busy / 1e3,
                norm_kernels_ms=norm_us / 1e3, norm_share=share)}


def train_then_serve_on_card(torch):
    """``repro_torch.launch.train_then_serve`` at the reference example's
    size (150 steps of 16 x 64 copy-task tokens, lr 5e-3) on the card,
    the counts set to 0 just before and read just after: the training
    steps run the exact norm forward and backward, the SOLE evaluation
    E2Softmax and the calibrating norm. Prints the exact and SOLE
    accuracies and the drop."""
    from repro_torch.launch import train_then_serve
    reset_launches()
    t0 = time.time()
    res = train_then_serve.main(["--device", "cuda"])
    torch.cuda.synchronize()
    launches = read_launches()
    log(f"[train_then_serve] {time.time() - t0:.2f} s; exact "
        f"{res['exact']:.4f}, SOLE {res['sole']:.4f}, drop "
        f"{res['drop']:+.4f}; launches "
        f"{json.dumps({k: v for k, v in launches.items() if v})}")
    for k in ("ailayernorm_exact", "ailayernorm_exact_bwd", "e2softmax",
              "ailayernorm_calib"):
        if not launches[k]:
            raise AssertionError(f"train_then_serve launched no {k}")
    if not res["losses"][-1] < res["losses"][0]:
        raise AssertionError("train_then_serve: loss did not fall")
    return {"accuracy_exact": res["exact"], "accuracy_sole": res["sole"],
            "drop": res["drop"], "launches": launches}


SMOKE_LOSS_RTOL = 1e-4             # card against CPU, float32 smoke steps
SMOKE_GNORM_RTOL = 1e-3


def small_train_parity(torch, workdir):
    """One smoke train step per config (float32 masters, seed 0, one
    ``make_batch`` of 8 x 32) on the card through the kernels against the
    same step on the CPU: loss within 1e-4 and grad norm within 1e-3
    relative (cuBLAS and the CPU sum in other orders). Then a smoke
    ``Trainer`` on the card with an induced failure at step 8
    (``fail_at``): it restores step 5 and completes every step."""
    from repro_torch.configs.base import ARCH_NAMES, ShapeConfig, get_config
    from repro_torch.data.pipeline import make_batch
    from repro_torch.models import api
    from repro_torch.models.state import tree_map
    from repro_torch.train.optimizer import OptConfig, global_norm
    from repro_torch.train.trainer import (Trainer, batch_to_device,
                                           loss_and_grads)
    shape = ShapeConfig("smoke", seq_len=32, global_batch=8, kind="train")
    res = {}
    for name in ARCH_NAMES:
        cfg = get_config(name).smoke()
        masters = api.init_params(0, cfg, "cpu", masters=True)
        b = make_batch(cfg, shape, 0)
        out = []
        for dev in ("cpu", "cuda"):
            loss, _, grads = loss_and_grads(
                tree_map(lambda t: t.to(dev), masters),
                batch_to_device(b, dev), cfg)
            out.append((loss.item(), global_norm(grads).item()))
        (lc, gc), (lg, gg) = out
        res[name] = {"loss_cpu": lc, "loss_cuda": lg, "gnorm_cpu": gc,
                     "gnorm_cuda": gg}
        log(f"[train smoke] {name}: loss cpu {lc:.7f} cuda {lg:.7f}; grad "
            f"norm cpu {gc:.6f} cuda {gg:.6f}")
        if (abs(lg - lc) > SMOKE_LOSS_RTOL * abs(lc)
                or abs(gg - gc) > SMOKE_GNORM_RTOL * gc):
            raise AssertionError(f"smoke train step {name}: card and CPU "
                                 "part")
    ckdir = os.path.join(workdir, "smoke_fail")
    shutil.rmtree(ckdir, ignore_errors=True)
    tr = Trainer(get_config("qwen2_0_5b").smoke(),
                 ShapeConfig("smoke", seq_len=64, global_batch=8,
                             kind="train"),
                 OptConfig(lr=1e-2, warmup_steps=5, total_steps=60),
                 device="cuda", ckpt_dir=ckdir, ckpt_every=5)
    out = tr.run(12, fail_at=8)
    steps = [m["step"] for m in out["metrics"]]
    log(f"[train smoke] fail_at 8: steps run {steps}")
    if len(steps) < 12 or sorted(set(steps)) != list(range(12)):
        raise AssertionError("failure recovery did not complete the steps")
    shutil.rmtree(ckdir, ignore_errors=True)
    res["fail_at_steps"] = steps
    return res


def train_phase(torch):
    """The training phase, each part timed: the backward kernel against
    its plain version, qwen2_0_5b at full width, train_then_serve, the
    smoke steps card vs CPU, the backward kernel's timings. Returns (its
    kernel-table entry, summaries)."""
    workdir = os.path.join(ROOT, "build", "train_smoke")
    os.makedirs(workdir, exist_ok=True)
    t0 = time.time()
    cases = check_norm_backward(torch)
    log(f"[phase time] norm backward checks: {time.time() - t0:.1f} s")
    t0 = time.time()
    full = train_full_width(torch, workdir)
    log(f"[phase time] qwen2_0_5b training: {time.time() - t0:.1f} s")
    t0 = time.time()
    tts = train_then_serve_on_card(torch)
    log(f"[phase time] train_then_serve: {time.time() - t0:.1f} s")
    t0 = time.time()
    smoke = small_train_parity(torch, workdir)
    log(f"[phase time] smoke train steps card vs cpu: "
        f"{time.time() - t0:.1f} s")
    t0 = time.time()
    entry = time_norm_backward(torch, cases, full["launches"])
    entry["launches_per_step"] = {
        "forward": full["launches"]["step0"]["forward"],
        "recompute": full["launches"]["step0"]["recompute"],
        "backward": full["launches"]["step0"]["backward"]}
    entry["launches_train_then_serve"] = tts["launches"][
        "ailayernorm_exact_bwd"]
    log(f"[phase time] norm backward timings: {time.time() - t0:.1f} s")
    shutil.rmtree(workdir, ignore_errors=True)
    return entry, {"qwen2_full": full["summary"], "train_then_serve": tts,
                   "smoke": smoke}



# -- serve_sole, the sanitizers and the dry run against the card -------------

SANITIZE_SWEEP = 4                 # refcount sweep every 4 engine steps
DRYRUN_TOL = 0.10                  # predicted peak bytes within 10% of measured
SWEEP_DIR = os.path.join(ROOT, "build", "dryrun_sweep")
SWEEP_TIMEOUT = 900
# sweep jobs run while the kernels build: the build runs one nvcc a source
# (five) on the machine's eight cores
EARLY_SWEEP_JOBS = 3
# the sweep starts these archs' jobs first: rwkv6_7b's two take about
# three times any other's host seconds (the log of each job's seconds
# says so), the rest follow in ``ARCH_NAMES`` order
SWEEP_FIRST = ("rwkv6_7b",)


def serve_sole_phase(torch):
    """``launch.serve_sole`` on the card: the example's smoke config, then
    qwen2_0_5b at full width, each paged and ``--dense``: every request
    gets its 12 tokens; the launcher prints tokens, tokens/s, peak pages
    and steps."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import serve_sole
    res = {}
    for label, cfg in (("smoke", None),
                       ("full width", get_config("qwen2_0_5b"))):
        out = serve_sole.main(["--dense"], cfg=cfg)
        for key in ("paged", "dense"):
            got = [len(o) for o in out[key]]
            if got != [12] * 12:
                raise AssertionError(f"serve_sole {label} {key}: {got}")
        res[label] = {k: out[k] for k in ("paged_tokens", "paged_s",
                                          "dense_tokens", "dense_s",
                                          "peak_pages", "steps")}
        log(f"[serve_sole {label}] paged {out['paged_tokens']} tokens "
            f"{out['paged_tokens'] / out['paged_s']:.1f} tok/s, dense "
            f"{out['dense_tokens'] / out['dense_s']:.1f} tok/s, peak pages "
            f"{out['peak_pages']}, {out['steps']} steps")
    return res


def sanitized_trace(torch):
    """The sanitizers on a full-width qwen2_0_5b ``PagedEngine`` trace:
    attached before a warm-up request, frozen after it, then the rest of
    the trace under the sync guard: no unsanctioned sync (one raises), no
    kernel library built and no device segment allocated after freeze
    (the sentinel raises), at least one refcount sweep; then an
    ``.item()`` injected into a step must raise."""
    from repro_torch.analysis.sanitizers import attach
    from repro_torch.configs.base import get_config
    from repro_torch.models import api
    from repro_torch.serve.engine import PagedEngine, Request
    cfg = get_config("qwen2_0_5b")
    params = api.init_params(0, cfg, "cuda")
    eng = PagedEngine(cfg, params, num_blocks=8 * MAX_SEQ_LEN // BLOCK_SIZE + 1,
                      block_size=BLOCK_SIZE, max_seq_len=MAX_SEQ_LEN,
                      max_running=8, decode_batch=DECODE_BATCH,
                      prefill_chunk=PREFILL_CHUNK, decode_horizon=8,
                      device="cuda")
    san = attach(eng, sweep_every=SANITIZE_SWEEP)
    prompts, _ = trace_prompts(cfg)
    reqs = [Request(prompt=p, max_new_tokens=NEW_TOKENS) for p in prompts]
    eng.generate(reqs[:1])                       # warm-up: builds, allocates
    frozen = san.freeze()
    warm_steps = san.steps
    outs = eng.generate(reqs[1:])                # guarded
    if [len(o) for o in outs] != [NEW_TOKENS] * (len(reqs) - 1):
        raise AssertionError(f"sanitized trace lengths {[len(o) for o in outs]}")
    rep = san.report()
    grown = {k: v for k, v in san.sentinel.sizes().items() if v > frozen[k]}
    if grown or rep["refcount_sweeps"] < 1 or rep["transfers_in_decode"]:
        raise AssertionError(f"sanitized trace: grown {grown}, {rep}")
    inner = san._inner_step
    san._inner_step = lambda: torch.ones(1, device="cuda").sum().item()
    try:
        eng.step()
    except RuntimeError as e:
        injected = f"{type(e).__name__}: {str(e).splitlines()[0][:120]}"
    else:
        raise AssertionError("an .item() inside a guarded step did not raise")
    finally:
        san._inner_step = inner
        san.detach()
        torch.cuda.set_sync_debug_mode(0)
    res = dict(rep, frozen=frozen, warmup_steps=warm_steps,
               guarded_steps=rep["sanitized_steps"] - warm_steps,
               injected_item=injected)
    log(f"[sanitizers] {json.dumps(res)}")
    del eng, params
    torch.cuda.empty_cache()
    return res


# -- tensor-parallel serving over a mesh of ranks (mesh_serve) -------------------

MESH_NEW_TOKENS = 8
MESH_PROMPT = 64                   # tokens of a mesh request's prompt, at most
MESH_FOUR_REQUESTS = 4             # the (1, 4) trace serves the first four
MESH_SPEC_REQUESTS = 3             # the n-gram trace serves the first three
MESH_SPAWN_TIMEOUT = 600           # seconds for one spawned battery
MESH_MODES = ("exact", "sole", "w8a8")
# the data axis, each on the first four requests: (2, 1) serves
# ``MESH_MODES``, (2, 2) SOLE and W8A8 and the dense-slot engine (exact)
MESH_DATA2_MODES = ("sole", "w8a8")
# per-rank paged shapes: (label, H, KV, d, M); every rank of the model axis
# is checked (the replicated-KV maps of qwen2 at M = 7 straddle KV heads on
# rank 3 and leave a pool head unread on the others)
# the MoE leg: mixtral_8x7b at full width, its depth cut (of 32 layers: 4
# hold 11.3 GB of bf16 expert weights on the single card, 5.6 GB a rank at
# (1, 2) and 2.8 GB at (2, 2)), on the first four requests
MESH_MOE_LAYERS = 4
MESH_PAGED_CASES = (("qwen2_m2", 14, 2, 64, 2), ("qwen2_m7", 14, 2, 64, 7),
                    ("minitron_m2", 32, 8, 128, 2),
                    ("minitron_m4", 32, 8, 128, 4),
                    ("recurrentgemma_m2", 16, 1, 256, 2))


def mesh_cfg(mode):
    """qwen2_0_5b as the mesh traces serve it: ``exact`` float32 (exact
    softmax and norms), ``sole`` bf16, ``w8a8`` SOLE with int8 KV."""
    from repro_torch.configs.base import QuantConfig, get_config
    cfg = get_config("qwen2_0_5b")
    if mode == "exact":
        return dataclasses.replace(cfg, softmax_mode="exact",
                                   norm_mode="exact", logit_int8=False,
                                   dtype="float32")
    if mode == "w8a8":
        return dataclasses.replace(cfg, quant=QuantConfig("w8a8"),
                                   kv_cache_dtype="int8")
    return cfg


def moe_mesh_cfg(mode):
    """mixtral_8x7b at full width and ``MESH_MOE_LAYERS`` layers as the
    MoE leg serves it: ``exact`` float32 (exact softmax and norms),
    ``sole`` bf16."""
    from repro_torch.configs.base import get_config
    cfg = dataclasses.replace(get_config("mixtral_8x7b"),
                              n_layers=MESH_MOE_LAYERS)
    if mode == "exact":
        return dataclasses.replace(cfg, softmax_mode="exact",
                                   norm_mode="exact", logit_int8=False,
                                   dtype="float32")
    return cfg


def mesh_requests(cfg, n=None):
    """The first ``n`` (all ten by default) of ten greedy requests: the
    trace's eight prompts, wave 2's and the first again (a prefix hit),
    each cut to ``MESH_PROMPT`` tokens (gloo stages every collective
    through host memory; each prompt is one 128-row prefill chunk). The
    third prompt repeats a 16-token run four times, so the n-gram drafter
    proposes from its first decode step."""
    import numpy as np
    from repro_torch.serve.engine import Request
    prompts, tail = trace_prompts(cfg)
    prompts[2] = np.tile(prompts[2][:16], 4)
    return [Request(prompt=p[:MESH_PROMPT], max_new_tokens=MESH_NEW_TOKENS)
            for p in prompts + [tail, prompts[0]]][:n]


class LogitsKeeper:
    """The first and the last forward's logits (whole rows, host memory)
    of the traces run inside it (``layers.lm_logits`` wrapped)."""

    def __enter__(self):
        from repro_torch.models import layers as L
        self.L, self.orig, self.first, self.last = L, L.lm_logits, None, None

        def keep(*a, **kw):
            out = self.orig(*a, **kw)
            if self.first is None:
                self.first = out.detach().float().cpu().numpy()
            self.last = out
            return out
        L.lm_logits = keep
        return self

    def __exit__(self, *exc):
        self.L.lm_logits = self.orig
        if self.last is not None:
            self.last = self.last.detach().float().cpu().numpy()


def mesh_params(torch, cfg, device):
    """qwen2_0_5b's weights from seed 0, drawn on ``device`` (the draws of
    the single-card phases) and moved to host memory: each engine moves
    what it keeps, so a rank's card holds only its slices and the peak
    measured from the engine's construction on counts them."""
    from repro_torch.models import api
    from repro_torch.models.state import tree_map
    params = tree_map(lambda t: t.cpu(), api.init_params(0, cfg, device))
    gc.collect()
    torch.cuda.empty_cache()
    return params


def card_params(torch, cfg, device, rules):
    """``cfg``'s weights from seed 0 drawn on ``device`` (the single card's
    draws) and, under ``rules``, cut there to this rank's slices (a
    ``ShardedTree`` the engine takes as it is), the whole tree freed: no
    host copy of a model whose experts take gigabytes. The ranks draw one
    at a time (a barrier after each), so a card the ranks share holds one
    whole tree at once."""
    import torch.distributed as dist
    from repro_torch.convert import shard_params
    from repro_torch.models import api
    from repro_torch.serve.engine import ShardedTree, _rank
    if rules is None:
        return api.init_params(0, cfg, device)
    out = None
    for r in range(dist.get_world_size()):
        if r == _rank():
            params = api.init_params(0, cfg, device)
            out = ShardedTree(shard_params(params, api.param_axes(cfg),
                                           rules, r))
            out.layout = (rules, r)
            del params
            gc.collect()
            torch.cuda.empty_cache()
        dist.barrier()
    return out


def mesh_trace(torch, mode, device, rules=None, sanitize=False, n=None,
               spec=0, cfg=None):
    """qwen2_0_5b at full width and depth (``mesh_cfg(mode)``) through
    ``PagedEngine`` on ``mesh_requests(cfg, n)``: one rank's engine under
    ``rules``, or the whole model without, built from host-memory weights
    after the peak is reset. Returns the tokens, the first and last
    forward's logits, launches, collectives of one prefill forward, the
    wall, peak memory (construction included) and parameter and pool
    bytes, and the seconds set-up took (weights, engine, the rest after
    the wall). ``sanitize``: the same requests again under the sanitizers'
    sync guard. ``spec``: the first ``spec`` requests again through an
    engine with the n-gram drafter on the same weights (its tokens and
    counters; exact mode's rows do not depend on the batch). ``cfg``: the
    model to serve in place of ``mesh_cfg(mode)`` (the MoE leg's, whose
    weights are drawn and cut on the card: ``card_params``)."""
    import numpy as np
    from repro_torch.serve.engine import PagedEngine, Request
    from repro_torch.serve.spec import NGramDrafter, SpecConfig
    from repro_torch.sharding import comm
    from repro_torch.sharding.rules import param_bytes
    t0 = time.time()
    if cfg is None:
        cfg = mesh_cfg(mode)
        params = mesh_params(torch, cfg, device)
    else:
        params = card_params(torch, cfg, device, rules)
    setup = {"weights": time.time() - t0}
    t0 = time.time()
    torch.cuda.reset_peak_memory_stats(device)
    kw = dict(num_blocks=10 * MAX_SEQ_LEN // BLOCK_SIZE + 1,
              block_size=BLOCK_SIZE, max_seq_len=MAX_SEQ_LEN, max_running=8,
              decode_batch=DECODE_BATCH, prefill_chunk=PREFILL_CHUNK,
              decode_horizon=8, device=device, rules=rules)
    eng = PagedEngine(cfg, params, **kw)
    del params
    setup["engine"] = time.time() - t0
    reqs = mesh_requests(cfg, n)
    reset_launches()
    san = guarded = None
    sec0, n0 = dict(comm.SECONDS), dict(comm.COUNTS)
    with LogitsKeeper() as keep:
        torch.cuda.synchronize(device)
        t0 = time.time()
        outs = eng.generate(reqs)
        if sanitize:
            # the trace above warmed the allocator and the kernel libraries
            # (a fresh rank's first requests do not reach its peak
            # shapes); the same requests again, prefix hits and all, run
            # under the guard
            from repro_torch.analysis.sanitizers import attach
            san = attach(eng)
            san.freeze()
            again = eng.generate(reqs)
            if [len(o) for o in again] != [MESH_NEW_TOKENS] * len(reqs):
                raise AssertionError("mesh guarded trace lengths")
            guarded = dict(san.report(), tokens_as_first_run=again == outs)
            san.detach()
        torch.cuda.synchronize(device)
        wall = time.time() - t0
    t_after = time.time()
    coll_s = sum(comm.SECONDS.values()) - sum(sec0.values())
    by_name = {k: {"calls": comm.COUNTS[k] - n0.get(k, 0),
                   "seconds": comm.SECONDS[k] - sec0.get(k, 0.0)}
               for k in comm.COUNTS if comm.COUNTS[k] > n0.get(k, 0)}
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
    if [len(o) for o in outs] != [MESH_NEW_TOKENS] * len(reqs):
        raise AssertionError(f"mesh {mode}: lengths {[len(o) for o in outs]}")
    before = dict(comm.COUNTS)
    eng.generate([Request(prompt=np.arange(1, 9, dtype=np.int32),
                          max_new_tokens=1)])
    per_forward = {k: comm.COUNTS[k] - before.get(k, 0) for k in comm.COUNTS
                   if comm.COUNTS[k] > before.get(k, 0)}
    eng.cache.check_refcounts()
    res = {}
    if rules is not None and rules.axis_sizes.get("data", 1) > 1:
        res["collectives_per_decode_step"] = decode_step_collectives(
            torch, eng, cfg, rules, device)
    res.update(tokens=outs, first=keep.first, last=keep.last, wall_s=wall,
               collective_s=coll_s, collective_share=coll_s / wall,
               collectives_in_trace=by_name,
               launches={k: v for k, v in launches.items() if v},
               collectives_per_forward=per_forward, peak_gib=peak,
               param_bytes=param_bytes(eng.params),
               pool_bytes=sum(p.numel() * p.element_size()
                              for p in eng.cache.pools.values()))
    if guarded is not None:
        res["sanitizer"] = guarded
    setup["after"] = time.time() - t_after
    res["setup_s"] = setup
    if spec:
        twin = PagedEngine(cfg, eng.params, spec_config=SpecConfig(
            NGramDrafter(), max_k=4), **kw)
        t0 = time.time()
        toks = twin.generate(mesh_requests(cfg, spec))
        torch.cuda.synchronize(device)
        twin.cache.check_refcounts()
        st = twin.stats()
        res["spec_ngram"] = dict(
            tokens=toks, wall_s=time.time() - t0,
            stats={k: st[k] for k in (
                "spec_dispatches", "spec_proposed_tokens",
                "spec_accepted_tokens", "decode_dispatches")})
        del twin
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return res


def decode_step_collectives(torch, eng, cfg, rules, device):
    """The collectives of one decode step of ``decode_batch`` null lanes
    (each on the null page) through ``eng``'s weights and pools under
    ``rules``: the model axis's, and over data one gather of the K/V rows
    a layer, one of the draws and, in SOLE mode, one max all-reduce a
    norm (and the MoE FFN's two all_to_all a layer)."""
    from repro_torch.models import api
    from repro_torch.sharding import comm
    from repro_torch.sharding.rules import use_rules
    b = eng.decode_batch
    zeros = torch.zeros((b,), dtype=torch.int32, device=device)
    tables = torch.zeros((b, 8), dtype=torch.int32, device=device)
    before = dict(comm.COUNTS)
    with use_rules(rules):
        api.get_model(cfg).decode_horizon_paged(
            eng.params, eng.cache.pools, zeros, zeros, tables, None, None,
            None, zeros, torch.full((b, 1), -1, dtype=torch.int32,
                                    device=device),
            cfg, num_steps=1, use_top_k=False, stochastic=False,
            use_eos=False)
    return {k: comm.COUNTS[k] - before.get(k, 0) for k in comm.COUNTS
            if comm.COUNTS[k] > before.get(k, 0)}


def mesh_dense_trace(torch, device, rules=None, n=MESH_FOUR_REQUESTS):
    """qwen2_0_5b at full width and depth in exact float32 through the
    dense-slot ``Engine``: one batch of the first ``n`` requests
    (left-padded to the longest prompt), one rank's engine under ``rules``
    or the whole model. Returns the tokens, the first and last forward's
    logits (a rank's lanes), launches, the collectives of a batch with
    one real request (one prefill and its sample), the wall."""
    import numpy as np
    from repro_torch.serve.engine import Engine, Request
    from repro_torch.sharding import comm
    from repro_torch.sharding.rules import param_bytes
    cfg = mesh_cfg("exact")
    params = mesh_params(torch, cfg, device)
    eng = Engine(cfg, params, batch_size=n,
                 max_len=MESH_PROMPT + MESH_NEW_TOKENS, device=device,
                 rules=rules)
    del params
    reqs = mesh_requests(cfg, n)
    reset_launches()
    with LogitsKeeper() as keep:
        torch.cuda.synchronize(device)
        t0 = time.time()
        outs = eng.generate(reqs)
        torch.cuda.synchronize(device)
        wall = time.time() - t0
    launches = read_launches()
    if [len(o) for o in outs] != [MESH_NEW_TOKENS] * len(reqs):
        raise AssertionError(f"mesh dense: lengths {[len(o) for o in outs]}")
    before = dict(comm.COUNTS)
    eng.generate([Request(prompt=np.arange(1, 9, dtype=np.int32),
                          max_new_tokens=1)])
    per_call = {k: comm.COUNTS[k] - before.get(k, 0) for k in comm.COUNTS
                if comm.COUNTS[k] > before.get(k, 0)}
    res = dict(tokens=outs, first=keep.first, last=keep.last, wall_s=wall,
               launches={k: v for k, v in launches.items() if v},
               collectives_per_forward=per_call,
               param_bytes=param_bytes(eng.params))
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return res


def mesh_rank(rank, world, jobs, backend, t_spawn, shape):
    """One rank of a ``shape`` (data, model) mesh (``launch.mesh.spawn``
    started it and its group): each job ``(label, mode, n, spec, dense,
    moe)`` a trace of ``mode`` on the first ``n`` requests (``spec`` > 0
    adds the n-gram trace of that many requests; ``dense``: the dense-slot
    engine's exact trace; ``moe``: of ``moe_mesh_cfg(mode)``); under nccl
    on its own card with the sanitizers' sync guard, under gloo on the
    shared card. Rank 0 returns the first
    forward's logits and every rank the last forward's (whole rows over
    the vocabulary; the rank's lanes of a dispatch the data axis splits,
    its data coordinate as ``data_index``). ``t_spawn``: the parent's
    clock at the spawn, for the seconds the rank took to start and each
    trace's."""
    import torch
    from repro_torch.launch.mesh import make_mesh, make_rules
    started = time.time() - t_spawn
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = (torch.device("cuda", rank) if backend == "nccl"
              else torch.device("cuda", 0))
    torch.cuda.set_device(device)
    rules = make_rules(make_mesh(shape, ("data", "model")))
    out = {"started_s": started, "trace_s": {},
           "data_index": rules.mesh.coordinate("data")}
    for label, mode, n, spec, dense, moe in jobs:
        t0 = time.time()
        if dense:
            res = mesh_dense_trace(torch, device, rules, n)
        else:
            res = mesh_trace(torch, mode, device, rules,
                             sanitize=backend == "nccl", n=n, spec=spec,
                             cfg=moe_mesh_cfg(mode) if moe else None)
        if rank:
            res.pop("first")
        out[label] = res
        out["trace_s"][label] = time.time() - t0
    out["done_s"] = time.time() - t_spawn
    return out


def check_data_split_kernels(torch):
    """The kernels of a data rank's share of a dispatch (D = 2: the
    second half of the lanes), each against the single card's launch on
    the whole batch, qwen2_0_5b's shapes: the paged kernel on lanes 4..7
    of an 8-lane decode step and on rows 20..39 of a 40-row verify
    dispatch run as decode rows (bf16 and int8 + ``quant_pv`` pools, SOLE
    and exact) bitwise those rows of the whole launch; the calibrating
    norm of a half of 8 decode rows, 40 verify rows and a 128-row chunk
    (RMS, C 896, bf16; bf16 out and int8 out), the other half's
    per-channel maxima folded in as the all-reduce over data folds them,
    through ``calibrated_norm_split`` (the static-params kernels) bitwise
    the calibrating kernel's rows, alpha and scale, and the split route
    timed against the calibrating kernel on a rank's 4, 20 and 64 rows
    (``split_norm_times``). Returns the cases' counts and the times."""
    from repro_torch.kernels import ailayernorm as KN
    from repro_torch.kernels import flash_e2softmax as KA
    from repro_torch.models.layers import KV_INT8_SCALE, LOGIT_INT8_SCALE
    gen = torch.Generator(device="cuda").manual_seed(30)
    half = DECODE_BATCH // 2
    kv40 = [1 if i % 9 == 4 else 1 + (37 * i) % 300 for i in range(40)]
    cases = {"decode": (DECODE_BATCH, [49, 300, 117, 1, 256, 83, 160, 1]),
             "verify_rows": (40, kv40)}
    checked = 0
    for name, (b, kv_lens) in cases.items():
        for int8 in (False, True):
            case = paged_case(torch, gen, b=b, c=1, q_start=[0] * b,
                              kv_lens=kv_lens, h=14, kvh=2, d=64, grid=True,
                              int8=int8)
            q, k, v, tables, meta = case
            for mode in ("sole", "exact"):
                kw = dict(sole=mode == "sole", exp_bits=4,
                          int8_scale=(LOGIT_INT8_SCALE if mode == "sole"
                                      else None))
                if int8:
                    kw.update(kv_scale=KV_INT8_SCALE, quant_pv=True)
                full = KA.flash_e2softmax_paged(*case, causal=False, **kw)
                part = KA.flash_e2softmax_paged(
                    q[b // 2:].contiguous(), k, v,
                    tables[b // 2:].contiguous(), meta[b // 2:].contiguous(),
                    causal=False, **kw)
                torch.cuda.synchronize()
                if not torch.equal(part, full[b // 2:]):
                    raise AssertionError(
                        f"data split paged {name} {'int8' if int8 else 'bf16'}"
                        f" {mode}: a half's launch differs from the whole "
                        "batch's rows")
                checked += 1
    norms, timed = {}, {}
    c = 896
    gamma = (1 + 0.1 * torch.randn((c,), generator=gen, device="cuda"))
    for rows in (DECODE_BATCH, 5 * DECODE_BATCH, PREFILL_CHUNK):
        x = (torch.randn((rows, c), generator=gen, device="cuda") * 3).to(
            torch.bfloat16)
        r = torch.randn((rows, c), generator=gen, device="cuda").to(
            torch.bfloat16)
        x[rows - 1, 17] = 60.0      # a channel whose max is in one half
        lo, hi = slice(0, rows // 2), slice(rows // 2, rows)
        for quant in (False, True):
            full = KN.calibrated_norm(x, r, gamma, None, rms=True,
                                      out_dtype=torch.bfloat16,
                                      quant_out=quant)
            for own, other in ((lo, hi), (hi, lo)):
                folded = (x[other] + r[other]).abs().amax(0)
                before = (KN.qnorm.launches, KN.add_norm_quant.launches)
                got = KN.calibrated_norm_split(
                    x[own], r[own], gamma, None, rms=True,
                    amax_reduce=lambda t, f=folded: torch.maximum(t, f),
                    out_dtype=torch.bfloat16, quant_out=quant)
                launched = (KN.qnorm.launches - before[0],
                            KN.add_norm_quant.launches - before[1])
                if launched != ((0, 1) if quant else (1, 0)):
                    raise AssertionError(f"split norm launches {launched}")
                torch.cuda.synchronize()
                want_res = ((full[1][0][own], full[1][1][own]) if quant
                            else (full[1][own],))
                got_res = got[1] if quant else (got[1],)
                same = (torch.equal(got[0], full[0][own])
                        and all(torch.equal(a, w)
                                for a, w in zip(got_res, want_res))
                        and torch.equal(got[2], full[2])
                        and torch.equal(got[3], full[3]))
                if not same:
                    raise AssertionError(
                        f"data split norm rows {rows} quant {quant}: not "
                        "the calibrating kernel's rows bitwise")
            norms[f"rows{rows}_{'int8' if quant else 'bf16'}"] = "bitwise"
        timed[rows // 2] = split_norm_times(torch, x[lo].contiguous(),
                                            r[lo].contiguous(), gamma,
                                            (x[hi] + r[hi]).abs().amax(0))
    log(f"[mesh data kernels] paged kernel on half the lanes: {checked} "
        "cases (8-lane decode, 40 verify rows as decode rows; bf16 and int8 "
        "pools; SOLE and exact) bitwise the whole launch's rows; the split "
        "calibrating norm (maxima folded over the halves, static-params "
        f"kernels) bitwise the calibrating kernel's rows: {json.dumps(norms)}")
    for rows, t in timed.items():
        log(f"[mesh data kernels] norm of a rank's {rows} rows (RMS, C {c}, "
            "bf16), split route (maxima folded in place of the all-reduce) "
            "against the calibrating kernel on the same rows: "
            + ", ".join(f"{out} out events {t[out]['split_ms'] * 1e3:.1f} "
                        f"against {t[out]['calib_ms'] * 1e3:.1f} us, host "
                        f"wall {t[out]['split_wall_ms'] * 1e3:.1f} against "
                        f"{t[out]['calib_wall_ms'] * 1e3:.1f} us"
                        for out in ("bf16", "int8")))
    return {"paged_cases": checked, "norm": norms, "norm_times": timed}


def split_norm_times(torch, x, r, gamma, folded):
    """``calibrated_norm_split`` of a rank's rows ``x``/``r`` (its maxima
    folded with ``folded``, the other ranks', in place of the max
    all-reduce) against ``calibrated_norm`` (one calibrating kernel) on
    the same rows, bf16 out and int8 out: device time by CUDA events and
    the host's wall a call (the split route is a chain of torch ops)."""
    from repro_torch.kernels import ailayernorm as KN
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda").zero_
    out = {}
    for name, quant in (("bf16", False), ("int8", True)):
        kw = dict(rms=True, out_dtype=torch.bfloat16, quant_out=quant)

        def split():
            return KN.calibrated_norm_split(
                x, r, gamma, None,
                amax_reduce=lambda t: torch.maximum(t, folded), **kw)

        def calib():
            return KN.calibrated_norm(x, r, gamma, None, with_params=False,
                                      **kw)
        out[name] = dict(split_ms=time_ms(torch, split, flush),
                         calib_ms=time_ms(torch, calib, flush),
                         split_wall_ms=wall_ms(torch, split),
                         calib_wall_ms=wall_ms(torch, calib))
    return out


def check_mesh_kernels(torch):
    """The paged kernel and the int8 GEMM at the per-rank shapes of the
    mesh plans, each local launch against its plain version (the card
    tests' bars: 1e-5 on exact-logit inputs at head dim 64 and 256; at 128
    exact mode 1e-4 of the output scale and SOLE at most 1% of rows off by
    more than 1e-3) and bitwise against the single card's launch on the
    same heads: decode (8 lanes, null lanes) and a 128-row causal chunk,
    bf16 pools and int8 pools with ``quant_pv``, SOLE and exact. Returns
    (paged results, GEMM results)."""
    from repro_torch.kernels import flash_e2softmax as KA
    from repro_torch.kernels import int8_matmul as KM
    from repro_torch.models.layers import KV_INT8_SCALE, LOGIT_INT8_SCALE
    gen = torch.Generator(device="cuda").manual_seed(29)
    shapes = {"decode": dict(b=DECODE_BATCH, c=1, q_start=[0] * DECODE_BATCH,
                             kv_lens=[49, 300, 117, 1, 256, 83, 160, 1]),
              "chunk": dict(b=1, c=PREFILL_CHUNK, q_start=[PREFILL_CHUNK],
                            kv_lens=[2 * PREFILL_CHUNK])}
    paged = {}
    for label, h, kvh, d, m in MESH_PAGED_CASES:
        hloc, g = h // m, h // kvh
        matched = kvh % m == 0
        kvloc = kvh // m if matched else kvh
        for name, sh in shapes.items():
            causal = name == "chunk"
            for int8 in (False, True):
                case = paged_case(torch, gen, h=h, kvh=kvh, d=d,
                                  grid=True, int8=int8, **sh)
                q, k, v, tables, meta = case
                for mode in ("sole", "exact"):
                    kw = dict(sole=mode == "sole", exp_bits=4,
                              int8_scale=(LOGIT_INT8_SCALE if mode == "sole"
                                          else None))
                    if int8:
                        kw.update(kv_scale=KV_INT8_SCALE, quant_pv=True)
                    full = KA.flash_e2softmax_paged(*case, causal=causal,
                                                    **kw)
                    worst, off = 0.0, 0.0
                    for s in range(m):
                        ql = q[:, s * hloc:(s + 1) * hloc].contiguous()
                        kl, vl = ((k, v) if not matched else
                                  (t[:, :, s * kvloc:(s + 1) * kvloc]
                                   .contiguous() for t in (k, v)))
                        first = 0 if matched else s * hloc
                        kvmap = ((torch.arange(hloc, device="cuda") + first)
                                 // g).to(torch.int32)
                        out = KA.flash_e2softmax_paged(
                            ql, kl, vl, tables, meta, kv_head_map=kvmap,
                            causal=causal, **kw)
                        ref = KA.flash_e2softmax_paged_plain(
                            ql, kl, vl, tables, meta, kvmap, causal=causal,
                            **kw)
                        torch.cuda.synchronize()
                        tag = (f"paged {label} rank {s} {name} "
                               f"{'int8' if int8 else 'bf16'} {mode}")
                        if not torch.equal(out, full[:, s * hloc:
                                                     (s + 1) * hloc]):
                            raise AssertionError(
                                f"{tag}: differs from the single-card "
                                "launch's heads")
                        err = (out - ref).abs()
                        scale = max(ref.abs().max().item(), 1.0)
                        worst = max(worst, err.max().item())
                        if d == 128 and mode == "sole":
                            frac = (err.amax(-1) > 1e-3 * scale).float(
                                ).mean().item()
                            off = max(off, frac)
                            bad = frac > 0.01
                        else:
                            bad = err.max().item() > (
                                1e-4 * scale if d == 128 else 1e-5 * scale)
                        if bad:
                            raise AssertionError(
                                f"{tag}: max |err| {err.max().item()} "
                                "against the plain version")
                    key = f"{label}_{name}_{'int8' if int8 else 'bf16'}_{mode}"
                    paged[key] = dict(max_abs_err=worst, rows_off=off,
                                      ranks=m, q_heads=hloc, pool_heads=kvloc)
        log(f"[mesh kernels] paged {label}: {hloc} q heads a rank on "
            f"{kvloc} {'own' if matched else 'replicated'} KV heads, d {d}: "
            "every rank bitwise the single-card launch's heads, within the "
            "plain version's bar (decode and 128-row chunk, bf16 and int8 "
            "+ quant_pv pools, SOLE and exact)")
    gemm = {}
    for pre, kn in (("", GEMM_KN), ("minitron_", MINITRON_GEMM_KN)):
        for nm, k, n in kn:
            row = nm in ("wq_wo", "down")       # wo and down contract K / 2
            for m in (DECODE_BATCH, PREFILL_CHUNK):
                x = torch.randint(-127, 128, (m, k), generator=gen,
                                  device="cuda", dtype=torch.int8)
                w = torch.randint(-127, 128, (k, n), generator=gen,
                                  device="cuda", dtype=torch.int8)
                whole = KM.int8_matmul(x, w)
                parts = []
                for s in range(2):
                    if row:
                        xs = x[:, s * k // 2:(s + 1) * k // 2].contiguous()
                        ws = w[s * k // 2:(s + 1) * k // 2].contiguous()
                    else:
                        xs, ws = x, w[:, s * n // 2:(s + 1) * n // 2
                                      ].contiguous()
                    out = KM.int8_matmul(xs, ws)
                    if not torch.equal(out, KM.int8_matmul_plain(xs, ws)):
                        raise AssertionError(f"int8_matmul {pre}{nm} rank {s}"
                                             f" m {m}: differs from plain")
                    parts.append(out)
                joined = (parts[0] + parts[1] if row
                          else torch.cat(parts, 1))
                if not torch.equal(joined, whole):
                    raise AssertionError(f"int8_matmul {pre}{nm} m {m}: the "
                                         "ranks' products do not make the "
                                         "single-card one")
                shape = ((m, k // 2, n) if row else (m, k, n // 2))
                gemm[f"{pre}{nm}_m{m}"] = dict(shape=shape, max_abs_err=0)
    log(f"[mesh kernels] int8_matmul at {len(gemm)} per-rank shapes "
        "(qwen2_0_5b's and minitron_8b's N / 2 and K / 2, M 8 and 128): "
        "bitwise the plain version; the K halves sum, and the N halves "
        "join, to the single-card product")
    return paged, gemm


def check_mesh_products(torch):
    """qwen2_0_5b's bf16 products in their tensor-parallel forms, each
    rank's on the single card's inputs (random bf16 weights and rows, seed
    29), prefill (64- and 128-row chunks: the plain forms) and decode (8
    rows through ``stable_mm``'s row tiles). Column-parallel, each rank's
    slice bitwise the single card's columns: q/k/v through
    ``layers._project_qkv`` (biases included) at M = 2, ``gate`` and ``up``
    at M = 2 and 4 (``apply_mlp``'s forms), the head through
    ``layers.lm_logits`` at M = 2 and 4. Row-parallel (``wo`` at M = 2,
    ``down`` at M = 2 and 4): the ranks' float32 partials (``out32``)
    summed and rounded once against the single card's product, every
    output within one bf16 rounding step (2^-7 of its magnitude) plus the
    float32 accumulation bound K 2^-23 (|a| @ |w|); the share of outputs
    that differ is returned per product and shape."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import layers as L
    cfg = get_config("qwen2_0_5b")
    d, h, kvh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    ff, voc = cfg.d_ff, cfg.padded_vocab
    gen = torch.Generator(device="cuda").manual_seed(29)

    def rnd(*shape, k=1):
        return (torch.randn(shape, generator=gen, device="cuda")
                * k ** -0.5).to(torch.bfloat16)

    attn = {"wq": rnd(d, h, hd, k=d), "wk": rnd(d, kvh, hd, k=d),
            "wv": rnd(d, kvh, hd, k=d), "bq": rnd(h, hd, k=64),
            "bk": rnd(kvh, hd, k=64), "bv": rnd(kvh, hd, k=64)}
    mlp = {"gate": rnd(d, ff, k=d), "up": rnd(d, ff, k=d)}
    wo, down, head = rnd(h, hd, d, k=h * hd), rnd(ff, d, k=ff), rnd(d, voc, k=d)

    def part(t, dim, r, m):
        n = t.shape[dim] // m
        return t.narrow(dim, r * n, n).contiguous()

    def col(a, w, stable):                  # apply_mlp's gate/up forms
        if not stable:
            return a @ w
        a2 = a.reshape(-1, a.shape[-1])
        return L.tile_mm(L.pad_rows(a2), w)[:a2.shape[0]]

    def row(a, w, stable):                  # a rank's wo or down partial
        a2 = a.reshape(-1, a.shape[-1])
        if stable:
            return L.tile_mm(L.pad_rows(a2), w, True)[:a2.shape[0]]
        return L.mm(a2, w, True)

    diff = {}
    for name, (b, s) in (("prefill_64", (1, 64)), ("prefill_128", (1, 128)),
                         ("decode", (DECODE_BATCH, 1))):
        stable = name == "decode"
        x = rnd(b, s, d)
        cases = []
        whole = L._project_qkv(attn, x, cfg, stable)
        cases += [(f"{t} m2", lambda r, i=i: L._project_qkv(
            {k: part(v, 1 if k[0] == "w" else 0, r, 2)
             for k, v in attn.items()}, x, cfg, stable)[i],
            whole[i], 2, 2) for i, t in enumerate("qkv")]
        for m in (2, 4):
            for k, w in mlp.items():
                cases.append((f"{k} m{m}", lambda r, w=w, m=m: col(
                    x, part(w, 1, r, m), stable), col(x, w, stable), m, -1))
            cases.append((f"head m{m}", lambda r, m=m: L.lm_logits(
                {"head": part(head, 1, r, m)}, x, cfg, stable),
                L.lm_logits({"head": head}, x, cfg, stable), m, -1))
        for label, got, want, m, dim in cases:
            for r in range(m):
                if not torch.equal(got(r), part(want, dim, r, m)):
                    raise AssertionError(f"mesh products {label} rank {r} "
                                         f"{name}: not the single card's "
                                         "columns bitwise")
        ctx, hid = rnd(b, s, h * hd), rnd(b, s, ff)
        for label, a, w, ms, single in (
                ("wo", ctx, wo.reshape(h * hd, d), (2,), L._wo_proj(
                    ctx.reshape(b, s, h, hd), {"wo": wo}, cfg, stable)),
                ("down", hid, down, (2, 4), col(hid, down, stable))):
            single = single.reshape(-1, d)
            k = w.shape[0]
            bound = (a.abs().float().reshape(-1, k) @ w.abs().float()
                     * (k * 2.0 ** -23))
            for m in ms:
                acc = sum(row(part(a, -1, r, m), part(w, 0, r, m), stable)
                          for r in range(m))
                tp = L.cast(acc, cfg)
                gap = (tp.float() - single.float()).abs()
                top = torch.maximum(tp.float().abs(), single.float().abs())
                if bool((gap > top * 2.0 ** -7 + bound).any()):
                    raise AssertionError(f"mesh products {label} m{m} {name}:"
                                         " the partials' sum is more than a "
                                         "rounding step from the card's")
                diff[f"{label}_m{m}_{name}"] = (tp != single).float().mean(
                    ).item()
    log("[mesh products] column-parallel q/k/v (M 2), gate/up and the head "
        "(M 2, 4): every rank's slice bitwise the single card's columns "
        "(prefill 64/128 rows, decode 8 rows through stable_mm); "
        "row-parallel wo/down, float32 partials summed and rounded once: "
        f"within a rounding step of the card's product, share of outputs "
        f"apart {json.dumps({k: round(v, 6) for k, v in diff.items()})}")
    return diff


def check_moe_mesh_products(torch):
    """mixtral_8x7b's expert products in their mesh forms on the card
    (``models/moe.py``; bf16 random weights and rows, seed 31), on a
    decode dispatch's (E, ROW_TILE, d) buffer through the row tiles and on
    a 128-row prefill chunk's (E, 128, d) buffer. Expert parallelism on a
    data axis of 2: rank r's experts 4r .. 4r + 3 on their rows of the
    buffer alone (route (b)) and, at decode, on route (a)'s (4, 2 cap, d)
    buffer of two sources' rows, bitwise the single card's experts. Tensor
    parallelism on a model axis of 2: ``gate``/``up`` on each rank's
    d_ff / 2 columns and ``down``'s float32 partials, summed and rounded
    once, within one bf16 rounding step (2^-7 of the magnitude) plus the
    float32 accumulation bound d_ff 2^-23 (|h| @ |down|) of the single
    card's outputs; the share of outputs apart is returned per buffer."""
    import torch.nn.functional as F
    from repro_torch.models import layers as L
    from repro_torch.models import moe as TM
    cfg = moe_mesh_cfg("sole")
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    e_loc, half = e // 2, f // 2
    gen = torch.Generator(device="cuda").manual_seed(31)

    def rnd(*shape, k=1):
        return (torch.randn(shape, generator=gen, device="cuda")
                * k ** -0.5).to(torch.bfloat16)

    wg, wu, wd = rnd(e, d, f, k=d), rnd(e, d, f, k=d), rnd(e, f, d, k=f)
    apart, checked = {}, 0
    for name, rows, stable in (("decode", L.ROW_TILE, True),
                               ("prefill_128", 128, False)):
        xe, other = rnd(e, rows, d), rnd(e, rows, d)
        whole = TM.expert_ffn(xe, wg, wu, wd, cfg, stable)
        whole_other = TM.expert_ffn(other, wg, wu, wd, cfg, stable)
        for r in range(2):
            s = slice(r * e_loc, (r + 1) * e_loc)
            w = (wg[s], wu[s], wd[s])
            got = [(TM.expert_ffn(xe[s], *w, cfg, stable), whole[s])]
            if stable:
                both = TM.expert_ffn(torch.cat([other[s], xe[s]], 1), *w,
                                     cfg, stable)
                got += [(both[:, :rows], whole_other[s]),
                        (both[:, rows:], whole[s])]
            for a, b in got:
                checked += 1
                if not torch.equal(a, b):
                    raise AssertionError(
                        f"moe mesh products {name} rank {r}: the rank's "
                        "experts are not the single card's bitwise")
        acc = sum(TM.expert_ffn(
            xe, wg[..., m * half:(m + 1) * half].contiguous(),
            wu[..., m * half:(m + 1) * half].contiguous(),
            wd[:, m * half:(m + 1) * half].contiguous(), cfg, stable,
            out32=True) for m in range(2))
        tp = acc.to(torch.bfloat16)
        h = F.silu(torch.bmm(xe, wg)) * torch.bmm(xe, wu)
        bound = torch.bmm(h.abs().float(), wd.abs().float()) * (f * 2.0 ** -23)
        gap = (tp.float() - whole.float()).abs()
        top = torch.maximum(tp.float().abs(), whole.float().abs())
        if bool((gap > top * 2.0 ** -7 + bound).any()):
            raise AssertionError(f"moe mesh products {name}: the down "
                                 "partials' sum is more than a rounding step "
                                 "from the card's")
        apart[f"down_m2_{name}"] = (tp != whole).float().mean().item()
        del h, bound, acc
    log(f"[moe mesh products] mixtral experts (d {d}, d_ff {f}, bf16): each "
        f"data rank's {e_loc} experts bitwise the single card's ({checked} "
        "buffers: decode 64-row tiles alone and as route (a)'s two-source "
        "buffer, 128-row prefill chunk); d_ff split over 2 model ranks, "
        "float32 down partials summed and rounded once: within a rounding "
        f"step of the card's, share of outputs apart {json.dumps(apart)}")
    del wg, wu, wd
    torch.cuda.empty_cache()
    return {"buffers_bitwise": checked, "tp_share_apart": apart}


def moe_mesh_leg(torch):
    """The MoE family under mesh rules (``models/moe.py``'s routes):
    ``check_moe_mesh_products``, then mixtral_8x7b at full width and
    ``MESH_MOE_LAYERS`` layers on the first ``MESH_FOUR_REQUESTS``
    requests, its ranks sharing the card over gloo, against the single
    card's traces: (2, 1) SOLE bf16 (decode dispatches through expert
    parallelism, prefill chunks through the replicated-batch route) with
    tokens and the first and last forward's logits bitwise the card's;
    (1, 2) exact float32 (expert-FF tensor parallelism) with the card's
    tokens, or parting inside a top-2 margin no larger than the measured
    logit difference; (2, 2) SOLE bf16 with every rank's tokens equal and
    their agreement with the card logged. Each trace's collectives a
    prefill forward and a decode step against the prediction, every
    rank's path launched; per rank its launches, the all_to_all calls and
    their host seconds, parameter bytes against the card's and peak
    memory logged. Where the machine shows two cards, the (2, 1) trace
    again over nccl, one card a rank. Each rank draws the whole model on
    the card before it keeps its slices, so one mesh spawns at a time
    (the (2, 1) ranks beside the single card's traces)."""
    from concurrent.futures import ThreadPoolExecutor
    t0 = time.time()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[mesh moe] this process holds {torch.cuda.memory_allocated() / 2 ** 30:.2f}"
        f" GiB of the card at the leg's start "
        f"({torch.cuda.memory_reserved() / 2 ** 30:.2f} GiB reserved)")
    products = check_moe_mesh_products(torch)
    dev = torch.device("cuda", 0)
    n4 = MESH_FOUR_REQUESTS
    with ThreadPoolExecutor(1) as pool:
        fut = pool.submit(mesh_spawn, (2, 1),
                          mesh_jobs(("sole",), n=n4, moe=True), "gloo")
        single = {m: mesh_trace(torch, m, dev, n=n4, cfg=moe_mesh_cfg(m))
                  for m in ("sole", "exact")}
        two_one = fut.result()
    one_two = mesh_spawn((1, 2), mesh_jobs(("exact",), n=n4, moe=True),
                         "gloo")
    two_two = mesh_spawn((2, 2), mesh_jobs(("sole",), n=n4, moe=True),
                         "gloo")
    n = MESH_MOE_LAYERS
    model = {"all_reduce_sum": 1 + 2 * n, "all_gather": 1}
    replicated = {"data.all_reduce_sum": n}
    step = {"data.all_gather": n + 1, "data.all_reduce_max": 2 * n + 1,
            "data.all_to_all": 2 * n}
    legs = {"2x1": ("sole", two_one, dict(replicated, agreed=1), step),
            "1x2": ("exact", one_two, dict(model, agreed=1), None),
            "2x2": ("sole", two_two, dict(model, **replicated, agreed=1),
                    dict(model, **step))}
    out = {"products": products, "single": {}}
    for mode, r in single.items():
        out["single"][mode] = {k: v for k, v in r.items()
                               if k not in ("tokens", "first", "last")}
        log(f"[mesh moe single card {mode}] wall {r['wall_s']:.2f} s, peak "
            f"{r['peak_gib']:.3f} GiB, params {r['param_bytes']} B, pools "
            f"{r['pool_bytes']} B; launches {json.dumps(r['launches'])}")
    for mesh, (mode, ranks, fwd, dstep) in legs.items():
        ref = single[mode]
        toks = [r[mode]["tokens"] for r in ranks]
        if any(t != toks[0] for t in toks):
            raise AssertionError(f"mesh moe {mesh} {mode}: the ranks' tokens "
                                 "differ")
        mesh_path_launched(f"mesh moe {mesh} {mode}", mode, ranks, mode,
                           split=mesh[0] == "2")
        r0 = ranks[0][mode]
        r0["first_max_abs_diff"] = float(abs(r0["first"]
                                             - ref["first"]).max())
        got = (r0["collectives_per_forward"],
               r0.get("collectives_per_decode_step"))
        if got != (fwd, dstep):
            raise AssertionError(f"mesh moe {mesh} {mode}: collectives a "
                                 f"prefill forward and a decode step {got}, "
                                 f"predicted {(fwd, dstep)}")
        entry = {"agreement_with_single_card": agreement(ref["tokens"],
                                                         toks[0]),
                 "first_max_abs_diff": r0["first_max_abs_diff"],
                 "ranks": [{k: v for k, v in r[mode].items()
                            if k not in ("tokens", "first", "last")}
                           for r in ranks]}
        if mesh == "2x1":
            lanes_ = r0["last"].shape[0]
            bitwise = dict(
                tokens=toks[0] == ref["tokens"],
                first=same_bits(r0["first"], ref["first"]),
                last=all(same_bits(r[mode]["last"], lane_rows(
                    ref["last"], lanes_, r["data_index"])) for r in ranks))
            if not all(bitwise.values()):
                raise AssertionError(f"mesh moe 2x1 sole: not bitwise the "
                                     f"single card: {bitwise}")
            entry["bitwise"] = True
        if mesh == "1x2":
            entry["divergence"] = moe_divergence(torch, ref["tokens"],
                                                 toks[0], r0)
        out[mesh] = {mode: entry}
        log(f"[mesh moe {mesh} {mode}] mixtral_8x7b {n} layers: tokens equal "
            f"on every rank; agreement with the single card "
            f"{entry['agreement_with_single_card']:.4f} ({n4} requests)"
            f"{', tokens and first/last logits bitwise' if mesh == '2x1' else ''}"
            f"; first forward's logits {entry['first_max_abs_diff']:.3e} "
            f"apart; collectives a prefill forward {json.dumps(fwd)}, a "
            f"decode step {json.dumps(dstep)}; card params "
            f"{ref['param_bytes']} B, peak {ref['peak_gib']:.3f} GiB")
        for i, r in enumerate(ranks):
            rr = r[mode]
            a2a = rr["collectives_in_trace"].get("data.all_to_all")
            log(f"[mesh moe {mesh} {mode} rank {i}] launches "
                f"{json.dumps(rr['launches'])}; all_to_all in the trace "
                f"{json.dumps(a2a)}; collectives in the trace "
                f"{json.dumps(rr['collectives_in_trace'])}; wall "
                f"{rr['wall_s']:.2f} s (gloo, correctness only), peak "
                f"{rr['peak_gib']:.3f} GiB, params {rr['param_bytes']} B "
                f"({rr['param_bytes'] / ref['param_bytes']:.4f} of the "
                "card's)")
    out["2x1_nccl"] = moe_nccl_leg(torch, single["sole"])
    log(f"[phase time] mesh moe leg: {time.time() - t0:.1f} s")
    return out


def moe_divergence(torch, single_tokens, tokens, r0):
    """None where ``tokens`` equal the single card's; else the first
    divergence, which must sit inside a top-2 margin no larger than the
    first forward's measured logit difference."""
    for i, (a, b) in enumerate(zip(single_tokens, tokens)):
        if a == b:
            continue
        j = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
        cfg = moe_mesh_cfg("exact")
        margin = first_divergence_margin(
            torch, cfg, mesh_requests(cfg)[i].prompt, a[:j])
        diff = r0["first_max_abs_diff"]
        log(f"[mesh moe 1x2 exact] request {i} parts at token {j}: top-2 "
            f"margin {margin:.3e}, measured logit difference {diff:.3e}")
        if margin > diff:
            raise AssertionError("mesh moe 1x2 exact: a divergence outside "
                                 "the measured logit difference")
        return dict(request=i, position=j, margin=margin, logit_diff=diff)
    return None


def moe_nccl_leg(torch, single_sole):
    """Where the machine shows two cards or more: the MoE leg's (2, 1)
    SOLE trace over nccl, one card a rank, under the sanitizers' sync
    guard, its tokens against the single card's. Says so where it cannot
    run."""
    cards = torch.cuda.device_count()
    if cards < 2:
        log(f"[mesh moe] (2, 1) nccl not run: the machine shows {cards} "
            "card(s) (nccl needs one a rank)")
        return f"not run: {cards} card(s) on this machine"
    ranks = mesh_spawn((2, 1), mesh_jobs(("sole",), n=MESH_FOUR_REQUESTS,
                                         moe=True), "nccl")
    toks = [r["sole"]["tokens"] for r in ranks]
    if any(t != toks[0] for t in toks):
        raise AssertionError("mesh moe 2x1 nccl: the ranks' tokens differ")
    san = ranks[0]["sole"]["sanitizer"]
    if san["transfers_in_decode"] or san["sanitized_steps"] < 1:
        raise AssertionError(f"mesh moe 2x1 nccl: sanitizer {san}")
    share = agreement(single_sole["tokens"], toks[0])
    log(f"[mesh moe 2x1 nccl sole] {cards} cards, one a rank: tokens equal "
        f"on both ranks, agreement with the single card {share:.4f}; rank 0 "
        f"wall {ranks[0]['sole']['wall_s']:.2f} s; sanitizer "
        f"{json.dumps(san)}")
    return {"agreement_with_single_card": share,
            "ranks": [{k: v for k, v in r["sole"].items()
                       if k not in ("tokens", "first", "last")}
                      for r in ranks]}


def first_divergence_margin(torch, cfg, prompt, prefix):
    """The single card's top-2 margin of the logits at the position after
    ``prompt`` + ``prefix`` (a teacher-forced dense forward)."""
    import numpy as np
    from repro_torch.models import api
    params = api.init_params(0, cfg, "cuda")
    toks = np.concatenate([prompt, np.asarray(prefix, np.int32)])[None]
    with torch.no_grad():
        logits = api.forward(params, {"tokens": torch.from_numpy(
            toks).cuda()}, cfg)[0, -1, :cfg.vocab_size]
    top = torch.topk(logits.float(), 2).values
    return float(top[0] - top[1])


def agreement(a, b):
    """The share of positions where two token lists of lists agree."""
    same = sum(x == y for p, q in zip(a, b) for x, y in zip(p, q))
    return same / max(sum(len(p) for p in a), 1)


def mesh_spawn(shape, jobs, backend):
    """``mesh_rank`` on a ``shape`` mesh with ``jobs`` (``mesh_jobs``);
    logs where its wall went (the ranks' start, their traces, the rest:
    exit and join)."""
    import math
    from repro_torch.launch.mesh import spawn
    t0 = time.time()
    ranks = spawn(mesh_rank, math.prod(shape), (jobs, backend, t0, shape),
                  backend=backend, timeout=MESH_SPAWN_TIMEOUT, threads=0)
    wall = time.time() - t0
    setup = {j[0]: {p: round(v, 1) for p, v in ranks[0][j[0]].get(
        "setup_s", {}).items()} for j in jobs}
    log(f"[phase time] mesh {tuple(shape)} {backend}: {wall:.1f} s (ranks "
        f"started after {max(r['started_s'] for r in ranks):.1f} s, done "
        f"after {max(r['done_s'] for r in ranks):.1f} s; rank 0's traces "
        f"{json.dumps({k: round(v, 1) for k, v in ranks[0]['trace_s'].items()})}"
        f", set-up {json.dumps(setup)})")
    return ranks


def mesh_jobs(modes, n=None, spec=0, dense=False, suffix="", moe=False):
    """``mesh_rank``'s jobs: a paged trace of each of ``modes`` on the
    first ``n`` requests (``spec`` n-gram requests beside the exact one),
    labelled by mode (plus ``suffix``); ``dense`` adds the dense-slot
    engine's exact trace, labelled ``dense_exact``; ``moe``: the traces
    serve the MoE leg's model (``moe_mesh_cfg``)."""
    jobs = [(mode + suffix, mode, n, spec if mode == "exact" else 0, False,
             moe) for mode in modes]
    if dense:
        jobs.append(("dense_exact", "exact", n, 0, True, False))
    return jobs


def first_diffs(ranks, firsts):
    """Rank 0's first forward against the single card's (``firsts`` by
    label), as ``first_max_abs_diff`` of each trace with such a label."""
    import numpy as np
    for label, res in ranks[0].items():
        if isinstance(res, dict) and "first" in res and label in firsts:
            res["first_max_abs_diff"] = float(
                np.abs(res.pop("first") - firsts[label]).max())
    return ranks


def lane_rows(ref, lanes_, index):
    """``ref``'s rows (dim 0) that data rank ``index`` of a batch split in
    ``lanes_``-row shares holds (all of them where the rows match)."""
    if ref.shape[0] == lanes_:
        return ref
    return ref[index * lanes_:(index + 1) * lanes_]


def same_bits(a, b) -> bool:
    return a.shape == b.shape and a.tobytes() == b.tobytes()


def mesh_serve_phase(torch):
    """Tensor-parallel paged serving (``PagedEngine(rules=)``): the kernels
    and the bf16 products at the per-rank shapes, then qwen2_0_5b at full
    width and depth on a (1, 2) mesh whose two ranks share the card over
    gloo (exact float32 with an n-gram spec trace held to its plain
    tokens, SOLE bf16, W8A8 + int8 KV) and on a (1, 4) mesh (SOLE bf16 on
    the first four requests: attention replicated, FFN and vocabulary
    sharded), each against the single card in this process; where the
    machine has two cards, the exact trace over nccl, one card a rank,
    under the sanitizers' sync guard. gloo stages every collective through
    host memory: its walls are correctness runs, no speed claim."""
    from concurrent.futures import ThreadPoolExecutor
    t0 = time.time()
    paged, gemm = check_mesh_kernels(torch)
    products = check_mesh_products(torch)
    data_kernels = check_data_split_kernels(torch)
    log(f"[phase time] mesh kernels and products: {time.time() - t0:.1f} s")
    four_n = MESH_FOUR_REQUESTS
    # the single card's traces run here while the (1, 2) and (2, 1) ranks
    # start and serve beside them; then (1, 4) and (2, 2) side by side
    with ThreadPoolExecutor(2) as pool:
        fut = pool.submit(mesh_spawn, (1, 2), mesh_jobs(
            MESH_MODES, spec=MESH_SPEC_REQUESTS) + mesh_jobs(
            ("sole",), n=four_n, suffix="_four"), "gloo")
        fut21 = pool.submit(mesh_spawn, (2, 1), mesh_jobs(
            MESH_MODES, n=four_n), "gloo")
        t0 = time.time()
        dev = torch.device("cuda", 0)
        single = {mode: mesh_trace(torch, mode, dev) for mode in MESH_MODES}
        single_four = {mode: mesh_trace(torch, mode, dev, n=four_n)
                       for mode in MESH_MODES}
        four_single = single_four["sole"]
        dense_single = mesh_dense_trace(torch, dev)
        firsts = {m: r.pop("first") for m, r in single.items()}
        log(f"[phase time] mesh single card (beside the (1, 2) and (2, 1) "
            f"ranks): {time.time() - t0:.1f} s")
        two = first_diffs(fut.result(), firsts)
        two_one = fut21.result()
    with ThreadPoolExecutor(2) as pool:
        fut4 = pool.submit(mesh_spawn, (1, 4), mesh_jobs(("sole",), n=four_n),
                           "gloo")
        two_two = mesh_spawn((2, 2), mesh_jobs(MESH_DATA2_MODES, n=four_n,
                                               dense=True), "gloo")
        four = first_diffs(fut4.result(), firsts)
    res = {"kernels": {"paged": paged, "int8_matmul": gemm,
                       "data_split": data_kernels},
           "products_share_apart": products, "single": {}}
    res.update(data_axis_checks(torch, two, two_one, two_two, single_four,
                                dense_single))
    for mesh, ranks in (("1x2", two), ("1x4", four)):
        for mode in MESH_MODES + ("sole_four",):
            if mode not in ranks[0]:
                continue
            toks = [r[mode]["tokens"] for r in ranks]
            if any(t != toks[0] for t in toks):
                raise AssertionError(f"mesh {mesh} {mode}: the ranks' tokens "
                                     "differ")
            mesh_path_launched(f"mesh {mesh} {mode}", mode.split("_")[0],
                               ranks, mode, split=False)
    # n-gram speculation on (1, 2): every rank's tokens are its plain
    # decode's (verify rows are decode rows bit for bit on each rank)
    for r, rr in enumerate(two):
        sp = rr["exact"].pop("spec_ngram")
        plain = rr["exact"]["tokens"][:MESH_SPEC_REQUESTS]
        if sp["tokens"] != plain:
            bad = sum(a != b for a, b in zip(sp["tokens"], plain))
            raise AssertionError(f"mesh 1x2 spec ngram rank {r}: {bad} "
                                 "requests differ from plain decode's")
        if not sp["stats"]["spec_dispatches"]:
            raise AssertionError("mesh 1x2 spec ngram: no verify dispatch")
        if r == 0:
            res["1x2_spec_ngram"] = {k: v for k, v in sp.items()
                                     if k != "tokens"}
            log(f"[mesh 1x2 exact ngram] every rank's tokens equal to its "
                f"plain decode's ({MESH_SPEC_REQUESTS} requests); "
                f"{json.dumps(sp['stats'])}; rank 0 "
                f"wall {sp['wall_s']:.2f} s (gloo, correctness only)")
    # exact float32: equal, or the first divergence inside a top-2 margin
    # no larger than the measured logit difference
    cfg = mesh_cfg("exact")
    ex, diff = two[0]["exact"]["tokens"], two[0]["exact"]["first_max_abs_diff"]
    divergence = None
    for i, (a, b) in enumerate(zip(single["exact"]["tokens"], ex)):
        if a != b:
            j = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
            margin = first_divergence_margin(
                torch, cfg, mesh_requests(cfg)[i].prompt, a[:j])
            divergence = dict(request=i, position=j, margin=margin,
                              logit_diff=diff)
            log(f"[mesh 1x2 exact] request {i} parts at token {j}: top-2 "
                f"margin {margin:.3e}, measured logit difference {diff:.3e}")
            if margin > diff:
                raise AssertionError("mesh 1x2 exact: a divergence outside "
                                     "the measured logit difference")
            break
    # W8A8 + int8 KV: tokens and the first and last logits bitwise
    w8 = two[0]["w8a8"]
    if w8["tokens"] != single["w8a8"]["tokens"]:
        raise AssertionError("mesh 1x2 w8a8: tokens differ from the card's")
    if w8["first_max_abs_diff"] != 0:
        raise AssertionError("mesh 1x2 w8a8: the first forward's logits "
                             "differ from the card's")
    if w8["last"].tobytes() != single["w8a8"]["last"].tobytes():
        bad = int((w8["last"] != single["w8a8"]["last"]).sum())
        raise AssertionError(f"mesh 1x2 w8a8: {bad} last logits differ")
    for mode in MESH_MODES:
        single[mode].pop("last")
    n = mesh_cfg("sole").n_layers
    want = {("1x2", "exact"): {"all_reduce_sum": 1 + 2 * n,
                               "all_gather": 1, "agreed": 1},
            ("1x2", "sole"): {"all_reduce_sum": 1 + 2 * n,
                              "all_gather": 1, "agreed": 1},
            ("1x2", "w8a8"): {"all_reduce_sum": 1 + 2 * n,
                              "all_reduce_max": 2 * n, "all_gather": 1,
                              "agreed": 1},
            # 14 heads on 4 ranks replicate attention: no wo all-reduce
            ("1x4", "sole"): {"all_reduce_sum": 1 + n, "all_gather": 1,
                              "agreed": 1}}
    for mesh, ranks in (("1x2", two), ("1x4", four)):
        for mode in MESH_MODES:
            if mode not in ranks[0]:
                continue
            got = ranks[0][mode]["collectives_per_forward"]
            if got != want[(mesh, mode)]:
                raise AssertionError(f"mesh {mesh} {mode}: collectives a "
                                     f"forward {got}")
            ref = (four_single if mesh == "1x4" else single[mode])["tokens"]
            share = agreement(ref, ranks[0][mode]["tokens"])
            entry = {"agreement_with_single_card": share,
                     "ranks": [{k: v for k, v in r[mode].items()
                                if k not in ("tokens", "last")}
                               for r in ranks]}
            res.setdefault(mesh, {})[mode] = entry
            log(f"[mesh {mesh} {mode}] tokens equal on every rank; agreement "
                f"with the single card {share:.4f} ({len(ref)} requests), "
                f"first forward's logits "
                f"{ranks[0][mode]['first_max_abs_diff']:.3e} apart; rank 0: wall "
                f"{ranks[0][mode]['wall_s']:.2f} s (gloo, correctness only; "
                f"{ranks[0][mode]['collective_share']:.3f} of it in the "
                f"collectives), "
                f"peak {ranks[0][mode]['peak_gib']:.3f} GiB, params "
                f"{ranks[0][mode]['param_bytes']} B, pools "
                f"{ranks[0][mode]['pool_bytes']} B; collectives a forward "
                f"{json.dumps(got)}; launches "
                f"{json.dumps(ranks[0][mode]['launches'])}")
    res["1x2"]["exact"]["divergence"] = divergence
    for mode, r in single.items():
        res["single"][mode] = {k: v for k, v in r.items() if k != "tokens"}
        log(f"[mesh single card {mode}] wall {r['wall_s']:.2f} s, peak "
            f"{r['peak_gib']:.3f} GiB, params {r['param_bytes']} B, pools "
            f"{r['pool_bytes']} B")
    res["1x2_nccl"] = nccl_leg(torch, single["exact"]["tokens"], firsts)
    res["2x2_nccl"] = nccl_data_leg(torch, single_four["exact"])
    res["moe"] = moe_mesh_leg(torch)
    return res


def mesh_path_launched(tag, mode, ranks, label, split):
    """Every kernel of ``mode``'s path launched on every rank in the trace
    ``label``: the paged kernel and the mode's norms (the calibrating
    norm for the replicated prefill chunks; ``split``: a data axis splits
    the decode dispatches, whose SOLE norms take the static-params
    kernels with the whole batch's maxima), the int8 GEMM at W8A8."""
    path = {"paged_e2softmax", "ailayernorm_exact"
            if mode == "exact" else "ailayernorm_calib"}
    if mode != "exact" and split:
        path.add("ailayernorm_add_norm_quant" if mode == "w8a8"
                 else "ailayernorm_qnorm")
    if mode == "w8a8":
        path.add("int8_matmul")
    for r, res_r in enumerate(ranks):
        idle = [k for k in path if not res_r[label]["launches"].get(k)]
        if idle:
            raise AssertionError(f"{tag} rank {r}: {idle} never launched on "
                                 "the path")


def data_axis_checks(torch, two, two_one, two_two, single_four,
                     dense_single):
    """The data axis's legs against their references. (2, 1): exact
    float32, SOLE bf16 and W8A8 + int8 KV on four requests, tokens and
    the first and last forward's logits bitwise the single card's (the
    last on each rank's lanes). (2, 2): W8A8 bitwise the single card, SOLE
    bitwise the (1, 2) ranks' four-request SOLE trace; the dense-slot
    engine's exact tokens equal on every rank and equal to the single
    card's dense engine, or parting inside a top-2 margin no larger than
    the measured logit difference. Every trace's collectives a prefill
    forward and a decode step against the prediction; each rank's paths
    launched."""
    n = mesh_cfg("sole").n_layers
    out = {}
    model = {"all_reduce_sum": 1 + 2 * n, "all_gather": 1}
    w8_model = dict(model, all_reduce_max=2 * n)
    kv_draws = {"data.all_gather": n + 1}
    calib = {"data.all_reduce_max": 2 * n + 1}
    want = {
        ("2x1", "exact"): ({"agreed": 1}, kv_draws),
        ("2x1", "sole"): ({"agreed": 1}, dict(kv_draws, **calib)),
        ("2x1", "w8a8"): ({"agreed": 1}, dict(kv_draws, **calib)),
        ("2x2", "sole"): (dict(model, agreed=1),
                          dict(model, **kv_draws, **calib)),
        ("2x2", "w8a8"): (dict(w8_model, agreed=1),
                          dict(w8_model, **kv_draws, **calib))}
    refs = {("2x1", m): (single_four[m], single_four[m]["last"])
            for m in MESH_MODES}
    refs[("2x2", "w8a8")] = refs[("2x1", "w8a8")]
    refs[("2x2", "sole")] = (two[0]["sole_four"], two[0]["sole_four"]["last"])
    for (mesh, mode), (fwd, step) in want.items():
        ranks = two_one if mesh == "2x1" else two_two
        toks = [r[mode]["tokens"] for r in ranks]
        if any(t != toks[0] for t in toks):
            raise AssertionError(f"mesh {mesh} {mode}: the ranks' tokens "
                                 "differ")
        mesh_path_launched(f"mesh {mesh} {mode}", mode, ranks, mode,
                           split=True)
        ref, last = refs[(mesh, mode)]
        r0 = ranks[0][mode]
        lanes_ = r0["last"].shape[0]
        bitwise = dict(tokens=toks[0] == ref["tokens"],
                       first=same_bits(r0["first"], ref["first"]),
                       last=all(same_bits(r[mode]["last"], lane_rows(
                           last, lanes_, r["data_index"])) for r in ranks))
        if not all(bitwise.values()):
            raise AssertionError(f"mesh {mesh} {mode}: not bitwise its "
                                 f"reference: {bitwise}")
        got = (r0["collectives_per_forward"],
               r0["collectives_per_decode_step"])
        if got != (fwd, step):
            raise AssertionError(f"mesh {mesh} {mode}: collectives a prefill "
                                 f"forward and a decode step {got}, "
                                 f"predicted {(fwd, step)}")
        out.setdefault(mesh, {})[mode] = {
            "bitwise": True, "ranks": [
                {k: v for k, v in r[mode].items()
                 if k not in ("tokens", "first", "last")} for r in ranks]}
        log(f"[mesh {mesh} {mode}] tokens, first logits (rank 0's) and "
            f"last logits (each rank's {lanes_} lanes) bitwise its reference ("
            f"{'(1, 2) four-request SOLE' if ref is not single_four.get(mode) else 'the single card'}"
            f"); collectives a prefill forward {json.dumps(fwd)}, a decode "
            f"step {json.dumps(step)}; rank 0: wall {r0['wall_s']:.2f} s "
            f"(gloo, correctness only), peak {r0['peak_gib']:.3f} GiB, "
            f"params {r0['param_bytes']} B, pools {r0['pool_bytes']} B; "
            f"launches {json.dumps(r0['launches'])}")
    # the dense-slot engine on (2, 2), exact float32
    toks = [r["dense_exact"]["tokens"] for r in two_two]
    if any(t != toks[0] for t in toks):
        raise AssertionError("mesh 2x2 dense: the ranks' tokens differ")
    r0 = two_two[0]["dense_exact"]
    lanes_ = r0["first"].shape[0]
    diff = float(abs(r0["first"] - lane_rows(dense_single["first"], lanes_,
                                             0)).max())
    cfg = mesh_cfg("exact")
    divergence = None
    for i, (a, b) in enumerate(zip(dense_single["tokens"], toks[0])):
        if a != b:
            j = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
            margin = first_divergence_margin(
                torch, cfg, mesh_requests(cfg)[i].prompt, a[:j])
            divergence = dict(request=i, position=j, margin=margin,
                              logit_diff=diff)
            log(f"[mesh 2x2 dense exact] request {i} parts at token {j}: "
                f"top-2 margin {margin:.3e}, measured logit difference "
                f"{diff:.3e}")
            if margin > diff:
                raise AssertionError("mesh 2x2 dense: a divergence outside "
                                     "the measured logit difference")
            break
    fwd = dict(model, agreed=1, **{"data.all_gather": 1})
    for r, rr in enumerate(two_two):
        if "ailayernorm_exact" not in rr["dense_exact"]["launches"]:
            raise AssertionError(f"mesh 2x2 dense rank {r}: the exact norm "
                                 "never launched")
    if r0["collectives_per_forward"] != fwd:
        raise AssertionError(f"mesh 2x2 dense: collectives a call "
                             f"{r0['collectives_per_forward']}, predicted "
                             f"{fwd}")
    out.setdefault("2x2", {})["dense_exact"] = {
        "tokens_equal_single_card": divergence is None,
        "first_max_abs_diff": diff, "divergence": divergence,
        "ranks": [{k: v for k, v in r["dense_exact"].items()
                   if k not in ("tokens", "first", "last")}
                  for r in two_two]}
    log(f"[mesh 2x2 dense exact] tokens equal on every rank, "
        f"{'equal to' if divergence is None else 'parting from'} the single "
        f"card's dense engine; first logits (rank 0's {lanes_} lanes) "
        f"{diff:.3e} apart; collectives a call {json.dumps(fwd)}; rank 0 "
        f"wall {r0['wall_s']:.2f} s (gloo, correctness only), launches "
        f"{json.dumps(r0['launches'])}")
    return out


def nccl_data_leg(torch, single_exact):
    """Where the machine shows four cards or more: the exact float32 trace
    on a (2, 2) mesh over nccl, one card a rank, under the sanitizers'
    sync guard, its tokens and first logits against the single card's
    four-request trace. Says so where it cannot run."""
    cards = torch.cuda.device_count()
    if cards < 4:
        log(f"[mesh] (2, 2) nccl not run: the machine shows {cards} card(s) "
            "(nccl needs one a rank)")
        return f"not run: {cards} card(s) on this machine"
    ranks = mesh_spawn((2, 2), mesh_jobs(("exact",), n=MESH_FOUR_REQUESTS),
                       "nccl")
    toks = [r["exact"]["tokens"] for r in ranks]
    if any(t != toks[0] for t in toks):
        raise AssertionError("mesh 2x2 nccl: the ranks' tokens differ")
    san = ranks[0]["exact"]["sanitizer"]
    if san["transfers_in_decode"] or san["sanitized_steps"] < 1:
        raise AssertionError(f"mesh 2x2 nccl: sanitizer {san}")
    first = float(abs(ranks[0]["exact"]["first"]
                      - single_exact["first"]).max())
    share = agreement(single_exact["tokens"], toks[0])
    log(f"[mesh 2x2 nccl exact] {cards} cards, one a rank: tokens equal on "
        f"every rank, agreement with the single card {share:.4f}, first "
        f"logits {first:.3e} apart; rank 0 wall "
        f"{ranks[0]['exact']['wall_s']:.2f} s, host share in the collectives "
        f"{ranks[0]['exact']['collective_share']:.3f}; sanitizer "
        f"{json.dumps(san)}")
    return {"agreement_with_single_card": share, "first_max_abs_diff": first,
            "ranks": [{k: v for k, v in r["exact"].items()
                       if k not in ("tokens", "first", "last")}
                      for r in ranks]}


def nccl_leg(torch, single_tokens, firsts):
    """Where the machine shows two cards or more: the (1, 2) exact trace
    over nccl, one card a rank, under the sanitizers' sync guard (the
    collectives must add no host sync), its tokens and first logits
    against the single card's. Says so where it cannot run."""
    cards = torch.cuda.device_count()
    if cards < 2:
        log(f"[mesh] nccl not run: the machine shows {cards} card (nccl "
            "needs one a rank)")
        return f"not run: {cards} card on this machine"
    nccl = first_diffs(mesh_spawn((1, 2), mesh_jobs(("exact",)), "nccl"),
                       firsts)
    toks = [r["exact"]["tokens"] for r in nccl]
    if any(t != toks[0] for t in toks):
        raise AssertionError("mesh 1x2 nccl: the ranks' tokens differ")
    san = nccl[0]["exact"]["sanitizer"]
    if san["transfers_in_decode"] or san["sanitized_steps"] < 1:
        raise AssertionError(f"mesh 1x2 nccl: sanitizer {san}")
    share = agreement(single_tokens, toks[0])
    log(f"[mesh 1x2 nccl exact] {cards} cards, one a rank: tokens equal "
        f"on both ranks, agreement with the single card {share:.4f}, "
        f"first-forward logit difference "
        f"{nccl[0]['exact']['first_max_abs_diff']:.3e}; rank 0 wall "
        f"{nccl[0]['exact']['wall_s']:.2f} s, host share in the "
        f"collectives {nccl[0]['exact']['collective_share']:.3f}; "
        f"sanitizer {json.dumps(san)}")
    return {"exact": {"agreement_with_single_card": share,
                      "ranks": [{k: v for k, v in r["exact"].items()
                                 if k not in ("tokens", "last")}
                                for r in nccl]}}


def _within(pred, measured) -> bool:
    return abs(pred / measured - 1) <= DRYRUN_TOL


def dryrun_train_check(torch):
    """Checks (a) and (c) of the dry run against one ``Trainer`` step of
    qwen2_0_5b at full width on the training phase's 8 x 1,024 tokens:
    the meta run's peak bytes within 10% of ``max_memory_allocated()``
    (reset just before the step; tensors alive before the Trainer left
    out), its roofline bound no larger than the step's device busy time,
    and its product FLOPs equal to ``FlopCounterMode``'s on the card."""
    from torch.profiler import ProfilerActivity, profile
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.data.pipeline import make_batch
    from repro_torch.launch import dryrun as D
    from repro_torch.roofline.analysis import PEAK_FLOPS, make_roofline
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.trainer import Trainer, batch_to_device
    cfg = get_config("qwen2_0_5b")
    shape = ShapeConfig("train_1k_b8", TRAIN_SEQ, TRAIN_BATCH, "train")
    t0 = time.time()
    counter, parts = D.count_cell(cfg, shape)
    cost = counter.cost
    roof = make_roofline(cfg, shape, "single", 1, cost)
    meta_s = time.time() - t0
    tr = Trainer(cfg, shape, OptConfig(lr=TRAIN_LR), device="cuda")
    tr.run(1)                                    # builds, cuBLAS workspaces
    gc.collect()             # earlier phases' garbage, freed not mid-step
    torch.cuda.synchronize()
    other = (torch.cuda.memory_allocated() - D.tree_bytes(tr.params)
             - D.tree_bytes(tr.opt_state))
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        tr.run(2)
        torch.cuda.synchronize()
    measured = torch.cuda.max_memory_allocated() - other
    busy = sum(r[0] for r in device_rows(torch, prof)) / 1e6
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.run(3)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    batch = batch_to_device(make_batch(cfg, shape, 3), "cuda")
    fc = FlopCounterMode(display=False)
    with fc:
        tr.step_fn(tr.params, tr.opt_state, batch)
    real_flops = fc.get_total_flops()
    res = dict(predicted_peak_bytes=int(cost.peak_bytes),
               measured_peak_bytes=int(measured),
               peak_ratio=cost.peak_bytes / measured,
               bound_s=roof.bound_s, bound_by=roof.dominant,
               device_busy_s=busy, step_wall_s=wall,
               bound_over_busy=roof.bound_s / busy,
               bound_over_wall=roof.bound_s / wall,
               model_flops=roof.model_flops,
               mfu=roof.model_flops / (PEAK_FLOPS["bfloat16"] * wall),
               product_flops_meta=cost.product_flops,
               product_flops_card=real_flops, meta_run_s=meta_s,
               resident=parts)
    log(f"[dryrun (a) train 8 x 1,024] {json.dumps(res)}")
    del tr, batch
    torch.cuda.empty_cache()
    if not _within(cost.peak_bytes, measured):
        raise AssertionError(f"(a) predicted peak {cost.peak_bytes} bytes, "
                             f"measured {measured}")
    if roof.bound_s > busy:
        raise AssertionError(f"(a) bound {roof.bound_s} s > busy {busy} s")
    if real_flops != cost.product_flops:
        raise AssertionError(f"(c) train product FLOPs: meta "
                             f"{cost.product_flops}, card {real_flops}")
    return res


def dryrun_decode_check(torch):
    """Checks (b) and (c) at one qwen2_0_5b paged decode step at the
    profiled wave's shape (8 lanes over its 257 pages of 16): the meta
    run's peak within 10% of the card's, product FLOPs equal."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.launch import dryrun as D
    from repro_torch.models import api
    cfg = get_config("qwen2_0_5b")
    shape = ShapeConfig("wave_decode", MAX_SEQ_LEN, DECODE_BATCH, "decode")
    counter, parts = D.count_cell(cfg, shape, paged=True)
    cost = counter.cost
    state, _, token, pos, refs = api.paged_decode_inputs(cfg, shape)
    params = api.init_params(0, cfg, "cuda")
    pools = {k: torch.zeros(v.shape, dtype=v.dtype, device="cuda")
             for k, v in state.items()}
    nb = refs["tables"].shape[1]
    tables = (torch.arange(DECODE_BATCH * nb, dtype=torch.int32,
                           device="cuda").reshape(DECODE_BATCH, nb) + 1)
    tok = torch.zeros(DECODE_BATCH, dtype=torch.int32, device="cuda")
    at = torch.full((DECODE_BATCH,), 160, dtype=torch.int32, device="cuda")

    def step():
        with torch.no_grad():
            return api.decode_step_paged(params, tok, at, {"tables": tables},
                                         pools, cfg)
    step()
    gc.collect()
    torch.cuda.synchronize()
    other = (torch.cuda.memory_allocated() - D.tree_bytes(params)
             - D.tree_bytes(pools)
             - sum(t.numel() * t.element_size() for t in (tables, tok, at)))
    torch.cuda.reset_peak_memory_stats()
    step()
    torch.cuda.synchronize()
    measured = torch.cuda.max_memory_allocated() - other
    fc = FlopCounterMode(display=False)
    with fc:
        step()
    real_flops = fc.get_total_flops()
    res = dict(predicted_peak_bytes=int(cost.peak_bytes),
               measured_peak_bytes=int(measured),
               peak_ratio=cost.peak_bytes / measured,
               product_flops_meta=cost.product_flops,
               product_flops_card=real_flops, resident=parts)
    log(f"[dryrun (b) paged decode 8 lanes] {json.dumps(res)}")
    del params, pools
    torch.cuda.empty_cache()
    if not _within(cost.peak_bytes, measured):
        raise AssertionError(f"(b) predicted peak {cost.peak_bytes} bytes, "
                             f"measured {measured}")
    if real_flops != cost.product_flops:
        raise AssertionError(f"(c) decode product FLOPs: meta "
                             f"{cost.product_flops}, card {real_flops}")
    return res


def _sweep_job(arch, paged, live):
    """One ``launch.dryrun --arch`` process over every shape on the
    host's CPU (meta tensors; registered in ``live`` while it runs); its
    exit code and its log's tail."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--out", SWEEP_DIR] + (["--paged"] if paged else [])
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env)
    live.add(proc)
    try:
        out, _ = proc.communicate(timeout=SWEEP_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, _ = proc.communicate()
    finally:
        live.discard(proc)
    return proc.returncode, out[-1500:]


class DryRunSweep:
    """(d): ``launch.dryrun`` over every arch and shape, dense and paged,
    one process per (arch, dense or paged), the longest
    (``SWEEP_FIRST``) first. ``early()`` runs jobs on ``EARLY_SWEEP_JOBS`` of the
    host cores the kernel build leaves free (one ``nvcc`` a source) and
    ``build_done()`` stops it taking new ones; ``finish()``, after the
    last timed phase, runs the rest on every core, waits for all, fails on
    any ``error`` cell and prints the cells that fit one card. ``abort()``
    ends whatever still runs."""

    def __init__(self):
        from repro_torch.configs.base import ARCH_NAMES
        shutil.rmtree(SWEEP_DIR, ignore_errors=True)
        os.makedirs(SWEEP_DIR)
        order = sorted(ARCH_NAMES, key=lambda a: a not in SWEEP_FIRST)
        self.jobs = [(arch, paged) for arch in order
                     for paged in (False, True)]
        self.todo = list(self.jobs)
        self.done, self.live, self.threads = {}, set(), []
        self.seconds = {}
        self.lock = threading.Lock()
        self.taking = False
        self.early_jobs = 0

    def _take(self):
        with self.lock:
            if not self.taking or not self.todo:
                return None
            self.early_jobs += 1
            return self.todo.pop(0)

    def _run(self, job):
        t0 = time.time()
        self.done[job] = _sweep_job(*job, self.live)
        self.seconds[job] = time.time() - t0

    def early(self, workers):
        def loop():
            job = self._take()
            while job is not None:
                self._run(job)
                job = self._take()
        self.taking = True
        self.threads = [threading.Thread(target=loop, daemon=True)
                        for _ in range(workers)]
        for t in self.threads:
            t.start()

    def build_done(self):
        with self.lock:
            self.taking = False

    def settle(self):
        """Wait for the jobs started during the build, so that no timed
        phase shares the host with the sweep; returns the seconds
        waited."""
        t0 = time.time()
        for t in self.threads:
            t.join()
        return time.time() - t0

    def finish(self):
        from concurrent.futures import ThreadPoolExecutor

        from repro_torch.roofline.report import load
        t0 = time.time()
        with self.lock:
            self.taking = False
            rest, self.todo = self.todo, []
        with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
            list(pool.map(self._run, rest))
        for t in self.threads:
            t.join()
        rows = load(SWEEP_DIR)
        errors = [f"{r['arch']} {r['shape']}: {r.get('error')}" for r in rows
                  if r["status"] == "error"]
        failed = [f"{arch}{' --paged' if paged else ''} rc {rc}\n{tail}"
                  for (arch, paged), (rc, tail) in self.done.items() if rc]
        if failed or errors or len(rows) != 80 or len(self.done) != len(
                self.jobs):
            raise AssertionError(f"(d) dry-run sweep: {len(rows)} cells, "
                                 f"errors {errors}, failed jobs {failed}")
        fits = [(r["arch"], r["shape"], r["memory"]["peak_bytes"])
                for r in rows if r["status"] == "ok"
                and r["memory"]["fits_one_card"]]
        log("[dryrun (d)] seconds a job (host wall, longest first): "
            + json.dumps({f"{a}{' --paged' if p else ''}": round(t, 1)
                          for (a, p), t in sorted(self.seconds.items(),
                                                  key=lambda kv: -kv[1])}))
        log(f"[dryrun (d)] {len(rows)} cells, "
            f"{sum(r['status'] == 'ok' for r in rows)} ok, "
            f"{sum(r['status'] == 'skipped' for r in rows)} skipped, 0 "
            f"errors ({len(self.jobs)} processes: {self.early_jobs} during "
            f"the kernel build, {len(rest)} here in "
            f"{time.time() - t0:.1f} s); fit one card:")
        for arch, shape, peak in fits:
            log(f"  {arch:24s} {shape:12s} peak {peak / 1e9:.2f} GB")
        return {"cells": len(rows), "fits": [f"{a} {s}" for a, s, _ in fits]}

    def abort(self):
        with self.lock:
            self.taking = False
            self.todo = []
        for proc in list(self.live):
            proc.kill()
        for t in self.threads:
            t.join(timeout=60)


def dryrun_phase(torch):
    """The card's total memory beside the constant the dry run compares
    with, then checks (a)-(c)."""
    from repro_torch.roofline.analysis import CARD_BYTES
    total = torch.cuda.get_device_properties(0).total_memory
    log(f"[dryrun] {torch.cuda.get_device_name(0)} total_memory {total} "
        f"bytes (roofline.analysis.CARD_BYTES {CARD_BYTES})")
    return {"total_memory": total, "train": dryrun_train_check(torch),
            "decode": dryrun_decode_check(torch)}


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
    sweep = None
    try:
        smi = nvidia_smi_line()
        log(f"card: {smi}")
        log(f"torch {torch.__version__} cuda {torch.version.cuda}, "
            f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
        t0 = time.time()
        sweep = DryRunSweep()
        sweep.early(EARLY_SWEEP_JOBS)
        logs = build.build_all()
        sweep.build_done()
        log(f"kernel build: {time.time() - t0:.1f} s")
        t_mark = [time.time()]

        def mark(name):
            now = time.time()
            log(f"[phase time] {name}: {now - t_mark[0]:.1f} s")
            t_mark[0] = now
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
                if (("mma_kernel" in fn or "decode_kernel" in fn)
                        and not any("BF16" in o for o in ops)):
                    raise AssertionError(f"{fn} issues no bf16 HMMA")
            for dp in (64, 128, 256):
                for kind in ("mma_kernel", "decode_kernel"):
                    if not any(f"paged_e2softmax_{kind}ILi{dp}E" in fn
                               for fn in sass):
                        raise AssertionError(f"no paged {kind} at head "
                                             f"dim {dp} in the SASS")
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
        verify16, verify8 = check_verify_kernels(torch, cfg, mini)
        attn.update(verify16)
        attn8.update(verify8)
        routes = compare_verify_decode_routes(torch, cfg)
        rows_check, rows_cases = verify_rows_as_decode(torch, cfg, mini,
                                                       attn)
        attn.update(rows_cases)
        norms = check_exact_norm(torch)
        gemm = check_int8_gemm(torch)
        e2 = check_e2softmax(torch, cfg)
        check_new_e2_stage(torch, mini, e2)
        rk = check_recurrent_kernels(torch)
        ops_inp = ops_inputs(torch)
        ops_res = check_ops_kernels(torch, ops_inp)
        log(f"[dryrun (d)] {sweep.early_jobs} jobs started during the "
            f"kernel build; waited {sweep.settle():.1f} s for them after the "
            "kernel checks")
        mark("kernel checks")
        launches, trace, params = serve_full_width(torch, cfg, "bf16")
        spec = spec_traces(torch, cfg, params, "bf16")
        spec["ops"] = verify_decode_ops(torch, cfg, params, "bf16")
        if not spec["ops"]["all_slots_bitwise"]:
            raise AssertionError("bf16 exact: a verify slot parts from its "
                                 "decode step")
        spec["sole_ngram"] = sole_ngram_trace(torch, cfg, params)
        spec["profiled"] = profile_spec(torch, cfg, params)
        open_loop = open_loop_trace(torch, cfg, params)
        launches8, trace8, params8 = serve_full_width(torch, cfg8, "w8a8")
        spec8 = spec_traces(torch, cfg8, params8, "w8a8")
        spec8["ops"] = verify_decode_ops(torch, cfg8, params8, "w8a8")
        if not spec8["ops"]["all_slots_bitwise"]:
            raise AssertionError("w8a8 exact: a verify slot parts from its "
                                 "decode step")
        dlaunches, dtrace = serve_dense_full_width(torch, cfg, params,
                                                   "dense bf16")
        dlaunches8, dtrace8 = serve_dense_full_width(torch, cfg8, params8,
                                                     "dense w8a8")
        olaunches = serve_ops_path(torch, ops_inp, ops_res)
        mark("qwen2_0_5b paths, spec, open loop, op layer")
        new = serve_new_configs(torch)
        mark("minitron_8b, nemotron_4_15b")
        new.update(serve_moe(torch))
        mark("mixtral_8x7b, dbrx_132b")
        rec = serve_recurrent(torch)
        mark("rwkv6_7b, recurrentgemma_9b")
        fk, flaunches, fams = serve_families(torch)
        mark("whisper_small, qwen2_vl_7b")
        train_entry, train = train_phase(torch)
        mark("training")
        sole = serve_sole_phase(torch)
        mark("serve_sole")
        sanitizers = sanitized_trace(torch)
        mark("sanitized trace")
        dry = dryrun_phase(torch)
        mark("dry run against the card")
        mesh = mesh_serve_phase(torch)
        mark("mesh_serve")
        for tag, res in rec.items():
            for key in ("paged", "paged_exact_warm", "dense"):
                new[f"{tag}_{key}"] = res[key]
        pair = draft_model_pair(torch)
        small_engine_parity(torch)
        small_spec_parity(torch)
        small_moe_parity(torch)
        small_recurrent_parity(torch)
        mark("draft pair, smoke engines")
        table = time_kernels(torch, attn, launches, cfg)
        table.append(time_calib_norm(torch, calib, launches))
        table += time_w8a8_kernels(torch, attn8, gemm, launches8, cfg)
        table += time_e2softmax(torch, e2, dlaunches, dlaunches8)
        table += time_ops_kernels(torch, ops_res, olaunches)
        table.append(time_exact_norm(torch, norms,
                                     spec["oracle"]["launches"]))
        table += time_recurrent_kernels(torch, rk, {
            "paged_e2softmax_mqa_d256":
                rec["hybrid"]["paged"][0]["paged_e2softmax"],
            "ailayernorm_calib_groupnorm":
                rec["rwkv6"]["paged"][0]["ailayernorm_calib"],
            "ailayernorm_exact_groupnorm":
                rec["rwkv6"]["paged_exact_warm"][0]["ailayernorm_exact"],
            "e2softmax_hybrid": rec["hybrid"]["dense"][0]["e2softmax"]})
        table += time_family_kernels(torch, fk, flaunches)
        table.append(train_entry)
        static = static_op_stage(torch)
        spec_launches = {
            **{f"bf16 exact {k}": spec[k]["launches"]
               for k in ("oracle", "anti-oracle", "ngram")},
            "bf16 sole ngram": spec["sole_ngram"]["launches"],
            **{f"w8a8 exact {k}": spec8[k]["launches"]
               for k in ("oracle", "ngram")},
            "open loop": open_loop["launches"],
            "nemotron + draft:minitron_8b": pair["launches"]}
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
            e["launches_spec_traces"] = {
                label: counts[key] for label, counts in spec_launches.items()
                if key in counts}
            e["launches_mesh_serve_rank0"] = {
                f"{m} {mode}": r["ranks"][0]["launches"][key]
                for m in ("1x2", "1x4", "2x1", "2x2")
                for mode, r in mesh[m].items()
                if key in r["ranks"][0]["launches"]}
            e["launches_mesh_moe_rank0"] = {
                f"{m} {mode}": r["ranks"][0]["launches"][key]
                for m in ("2x1", "1x2", "2x2")
                for mode, r in mesh["moe"][m].items()
                if key in r["ranks"][0]["launches"]}
        mark("timings")
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
                        "verify_decode_routes": routes,
                        "verify_rows_as_decode": rows_check,
                        "spec_bf16": spec,
                        "spec_w8a8": spec8, "open_loop": open_loop,
                        "draft_pair": pair,
                        "families": fams,
                        "training": train, "serve_sole": sole,
                        "sanitizers": sanitizers, "dryrun": dry,
                        "mesh_serve": mesh,
                        "recurrent_profiles": {
                            tag: {k: v for k, v in res.items()
                                  if k in ("profile", "resident_gib")}
                            for tag, res in rec.items()},
                        **{f"trace_{k}": v[1] for k, v in new.items()}}))
        mark("qwen2_0_5b profiled waves")
        log(json.dumps({"dryrun_sweep": sweep.finish()}))
        mark("dry-run sweep (d)")
        log(f"chip_smoke: every phase passed in {time.time() - t_start:.1f} s")
    except Exception:
        traceback.print_exc()
        return 1
    finally:
        if sweep is not None:
            sweep.abort()
    print(json.dumps({"kernels": table}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
