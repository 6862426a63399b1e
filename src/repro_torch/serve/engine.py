"""Serving engines: prefix-cached paged continuous batching
(PagedEngine) and the dense-slot batched engine (Engine).

A ref-counted, shared-page KV pool (serve/kv_cache.py) with token-level
continuous batching, chunked prefill, prefix caching and
recompute-preemption (serve/scheduler.py). On admission each prompt is
hashed block by block against the page index; matched pages are
attached and only the tail is prefilled. Pages are allocated on demand;
a write into a shared page is copy-on-write, replayed on the device
before the model step. Prefill-chunk and decode attention both stream
pages through the paged Flash-E2Softmax kernel on CUDA.

``Engine`` serves fixed batches of requests against stacked dense
caches: one whole-prompt prefill per batch (left-padded, per-lane
positions), then one decode step per token; its attention softmax runs
the E2Softmax kernel on CUDA.

Both engines run on ``device`` ("cuda" unless the caller asks for the
CPU, where every op runs its plain torch version); they never fall back
from one to the other. Under ``cfg.quant`` w8a16/w8a8 each packs the
matmul weights to int8 at construction (every projection and the LM head
then run through the int8 GEMM kernel at w8a8), and
``cfg.kv_cache_dtype="int8"`` keeps int8 KV pages or dense caches.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.sole.quant import is_qtensor
from repro_torch.models import api
from repro_torch.serve.kv_cache import PagedKVCache, copy_pages
from repro_torch.serve.sampling import (Sampler, apply_finish, eos_table,
                                        sample_tokens, sampler_for)
from repro_torch.serve.scheduler import Scheduler, Sequence
from repro_torch.sharding.rules import QUANT_WEIGHT_SPEC, quantize_params


@dataclasses.dataclass
class Request:
    prompt: np.ndarray           # (prompt_len,) int32
    max_new_tokens: int = 16
    temperature: float = 0.0     # 0 = greedy argmax
    top_k: int = 0               # 0 = full vocab
    seed: int = 0                # per-request sampling stream
    # finish events: sampling any of eos_ids ends the request ("eos");
    # stop holds multi-token sequences matched over the generated tokens
    # ("stop"). The finishing token / sequence is kept in the output.
    eos_ids: Tuple[int, ...] = ()
    stop: Tuple[Tuple[int, ...], ...] = ()


def _check_float32_masters(tree, key=None) -> None:
    if isinstance(tree, dict):
        if not is_qtensor(tree):
            for k, v in tree.items():
                _check_float32_masters(v, k)
    elif key in QUANT_WEIGHT_SPEC and tree.dtype != torch.float32:
        raise ValueError(
            f"weight {key!r} is {tree.dtype}: quantized serving packs int8 "
            "codes from float32 masters (init_params and params_from_jax "
            "keep them under cfg.quant.weights)")


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


def _resolve_device(device, engine: str) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{engine}: no CUDA device is available; pass device='cpu' to "
            "serve with the plain torch ops")
    return device


def _sampling_tensors(streams, use_top_k: bool, stochastic: bool, tensor):
    """Per-lane (temperature, top_k, seed, counter) rows -> the four device
    tensors ``sample_tokens`` takes (float32, int64 x 3), or Nones where a
    batch with no top-k and no temperature reads none of them."""
    if not (use_top_k or stochastic):
        return None, None, None, None
    cols = np.array(streams, np.float64).T      # exact for uint32 seeds
    return (tensor(cols[0].astype(np.float32)),
            *(tensor(c.astype(np.int64)) for c in cols[1:]))


def _serving_params(cfg: ArchConfig, params, device):
    """The engine's parameter tree on ``device``: under ``cfg.quant.weights``
    every matmul weight packed to int8 + per-channel scales, as the
    reference engines do (idempotent), from float32 masters only (codes
    packed from bf16 would differ)."""
    if cfg.quant.weights:
        _check_float32_masters(params)
        params = quantize_params(params)
    return _to_device(params, device)


class PagedEngine:
    """Continuous-batching engine over paged KV for the dense family.

    Each step admits waiting requests, runs one prefill chunk of one
    sequence (B=1, C=``prefill_chunk``; the final chunk padded with
    token 0, its tail written to the null page) and one **decode
    horizon** for up to ``decode_batch`` sequences: H fused decode
    steps on the device (short batches padded with null lanes:
    token 0, position 0, all-null table), each step sampling its token on
    the device from the lane's counter-keyed stream, with only the (B, H)
    sampled ids copied to the host. The padding matters in SOLE mode: PTF
    calibration reduces over the whole batch, so padded rows take part
    in every norm exactly as in the reference engine.

    Features the port does not have yet raise here rather than being
    silently downgraded: other families, speculative decoding and mesh
    rules.
    """

    def __init__(self, cfg: ArchConfig, params, *, num_blocks: int = 64,
                 block_size: int = 16, max_seq_len: int = 256,
                 max_running: int = 8, decode_batch: int = 4,
                 prefill_chunk: int = 16, decode_horizon: int = 8,
                 device="cuda", prefix_cache: Optional[bool] = None,
                 watermark: int = 1, rules=None, spec_config=None):
        device = _resolve_device(device, "PagedEngine")
        if cfg.quant.weights and cfg.family not in ("dense", "moe"):
            raise ValueError(
                f"family {cfg.family!r} has no quantized serving path "
                "(quant.weights is dense/moe-only)")
        if cfg.family != "dense":
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported yet (ROADMAP.md "
                "queue 1 item 7)")
        if spec_config is not None:
            raise NotImplementedError(
                "speculative decoding is not ported yet (ROADMAP.md queue 1 "
                "item 5)")
        if rules is not None:
            raise NotImplementedError(
                "sharding rules are not ported yet (ROADMAP.md queue 1 "
                "item 9)")
        state_spec = api.sequence_state_spec(cfg)
        if cfg.window and max_seq_len > cfg.window:
            raise ValueError(
                "pages are append-only: serving past the sliding window "
                f"(max_seq_len {max_seq_len} > window {cfg.window}) would "
                "keep dead KV resident; cap max_seq_len at the window")
        if prefix_cache is None:
            prefix_cache = state_spec.supports_prefix_cache
        if decode_horizon < 1:
            raise ValueError(
                f"decode_horizon must be >= 1, got {decode_horizon}")
        self.cfg = cfg
        self.device = device
        self.prefix_cache = prefix_cache
        self.params = _serving_params(cfg, params, device)
        self.decode_batch = decode_batch
        self.decode_horizon = decode_horizon
        self.cache = PagedKVCache(cfg, num_blocks=num_blocks,
                                  block_size=block_size,
                                  max_seq_len=max_seq_len,
                                  prefix_cache=prefix_cache, device=device)
        self.sched = Scheduler(self.cache, max_running=max_running,
                               prefill_chunk=prefill_chunk,
                               watermark=watermark)
        self.steps = 0
        self.decode_tokens = 0
        self.decode_dispatches = 0
        self.truncated_tokens = 0        # horizon-tail draws discarded
        self.reclaimed_pages = 0         # pages handed back by truncate
        self.finish_reasons: Dict[str, int] = {}
        self._finished: Dict[int, List[int]] = {}

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _apply_copies(self, copies: List[Tuple[int, int]]) -> None:
        """Replay COW page duplications on the device before the step
        that writes into the fresh private pages."""
        if not copies:
            return
        src, dst = zip(*copies)
        copy_pages(self.cache.pools, self._tensor(np.array(src, np.int64)),
                   self._tensor(np.array(dst, np.int64)))

    def _refs(self, seqs: List[Optional[Sequence]]) -> Dict[str, torch.Tensor]:
        """Page tables for a padded batch; ``None`` lanes get null rows."""
        sids = [s.seq_id if s is not None else None for s in seqs]
        return {"tables": self._tensor(self.cache.batch_tables(sids))}

    # -- one engine iteration -------------------------------------------------

    def _prefill_step(self, seq: Sequence) -> None:
        c = self.sched.prefill_chunk
        start = seq.prefilled
        replay = seq.replay_tokens
        real = min(c, len(replay) - start)
        copies = self.sched.ensure_tokens(seq, start, start + real)
        if copies is None:
            return                       # seq itself was preempted
        self._apply_copies(copies)
        chunk = np.zeros((1, c), np.int32)
        chunk[0, :real] = replay[start:start + real]
        logits, state = api.prefill_paged(
            self.params, self._tensor(chunk),
            self._tensor(np.array([start], np.int32)),
            self._tensor(np.array([real], np.int32)), self._refs([seq]),
            self.cache.pools, self.cfg)
        self.cache.pools = state
        seq.prefilled = start + real
        if not seq.in_prefill:
            self.cache.register_prompt(seq.seq_id, seq.prompt,
                                       seq.prefix_keys)
            if not seq.out:
                # fresh sequence: the first generated token comes from the
                # last real prompt position's logits (a resumed sequence
                # already holds its next feed token in out).
                tok = seq.sampler(logits[0, real - 1].cpu().numpy())
                # the first token can already be a finish event.
                _, seq.finish_reason = apply_finish(seq.sampler, seq.out,
                                                    [tok])

    def _decode_step(self) -> None:
        batch = self.sched.decode_batch(self.decode_batch)
        # horizon: largest event-safe token count, floored to a power of
        # two (the reference's compiled-shape discipline, kept so both
        # engines take the same steps).
        h = self.sched.decode_horizon(batch, self.decode_horizon)
        if h == 0:
            return
        h = 1 << (h.bit_length() - 1)
        lanes: List[Sequence] = []
        for seq in batch:
            if seq not in self.sched.running:
                continue                 # preempted by an earlier lane
            pos = seq.prompt_len + len(seq.out) - 1
            # pre-extend the page table for the whole horizon.
            copies = self.sched.ensure_tokens(seq, pos, pos + h)
            if copies is None:
                continue
            self._apply_copies(copies)
            lanes.append(seq)
        # ensure_tokens preempts youngest-first and stops at the requesting
        # seq, so a later lane's growth never evicts a lane collected above.
        assert all(s in self.sched.running for s in lanes)
        if not lanes:
            return
        d = self.decode_batch
        token = np.zeros((d,), np.int32)
        pos = np.zeros((d,), np.int32)
        seqs: List[Optional[Sequence]] = [None] * d
        for i, seq in enumerate(lanes):
            token[i] = seq.out[-1]
            pos[i] = seq.prompt_len + len(seq.out) - 1
            seqs[i] = seq
        widest = max(len(s.sampler.eos_ids) for s in lanes)
        use_eos = widest > 0
        eos = np.full((d, 1), -1, np.int32)
        if use_eos:
            eos = np.full((d, widest), -1, np.int32)
            eos[:len(lanes)] = eos_table([s.sampler for s in lanes], widest)
        # the sampling fast paths: skipping the rank sort / the Gumbel rows
        # is an identity for lanes that use no top-k / temperature, so the
        # flags come from the live batch (an all-greedy batch ships no
        # sampling tensors at all)
        use_top_k = any(s.sampler.top_k > 0 for s in lanes)
        stochastic = any(not s.sampler.greedy for s in lanes)
        # token n of a sequence draws with counter n: the host sampler
        # spent counter 0 on the prefill-logits token, so the device stream
        # continues where it left off; null lanes are greedy
        streams = [(s.sampler.temperature, s.sampler.top_k, s.sampler.seed,
                    len(s.out)) for s in lanes]
        streams += [(0.0, 0, 0, 0)] * (d - len(lanes))
        toks, done, state = api.decode_horizon_paged(
            self.params, self._tensor(token), self._tensor(pos),
            self._refs(seqs), self.cache.pools,
            *_sampling_tensors(streams, use_top_k, stochastic, self._tensor),
            self._tensor(eos), self.cfg, num_steps=h, use_top_k=use_top_k,
            stochastic=stochastic, use_eos=use_eos)
        self.cache.pools = state
        # the one device-to-host copy of the horizon
        host = torch.cat([toks, done.to(torch.int32)], 1).cpu().numpy()
        rows, done_rows = host[:, :h], host[:, h:].astype(bool)
        for i, seq in enumerate(lanes):
            # cut the lane at its first finish event; draws after the cut
            # never entered the stream.
            kept, reason = apply_finish(seq.sampler, seq.out, rows[i],
                                        eos_row=done_rows[i])
            seq.sampler.skip(kept)       # the host stream stays aligned
            seq.prefilled = int(pos[i]) + kept
            self.decode_tokens += kept
            self.truncated_tokens += h - kept
            if reason is not None:
                seq.finish_reason = reason
                self.reclaimed_pages += self.cache.truncate(
                    seq.seq_id, int(pos[i]) + kept)
        self.decode_dispatches += 1

    def _reap_done(self) -> None:
        for seq in list(self.sched.running):
            if seq.done:
                seq.finish_reason = seq.finish_reason or "length"
                self.finish_reasons[seq.finish_reason] = (
                    self.finish_reasons.get(seq.finish_reason, 0) + 1)
                self._finished[seq.seq_id] = seq.out
                self.sched.finish(seq)

    def step(self) -> None:
        """One engine iteration: admit, one prefill chunk, one decode
        horizon for the running batch, reclaim finished sequences."""
        self.sched.admit()
        seq = self.sched.next_prefill()
        if seq is not None:
            self._prefill_step(seq)
        self._reap_done()
        self._decode_step()
        self._reap_done()
        self.steps += 1

    # -- public API -----------------------------------------------------------

    def submit(self, request: Request) -> Sequence:
        """Validate and queue one request; returns its live Sequence."""
        return self.sched.submit(
            request.prompt, request.max_new_tokens,
            sampler=sampler_for(request, self.cfg.vocab_size))

    def generate(self, requests: List[Request]) -> List[List[int]]:
        """Serve all requests to completion; outputs in request order."""
        order: List[int] = []
        for i, r in enumerate(requests):
            try:
                order.append(self.submit(r).seq_id)
            except (ValueError, NotImplementedError) as e:
                self.sched.abandon(order)
                raise type(e)(f"request {i}: {e}") from None
        while self.sched.has_work:
            self.step()
        return [self._finished.pop(sid) for sid in order]

    def stats(self) -> Dict[str, object]:
        """Serving counters: prefix-cache hits, COW/eviction/preemption
        activity, pool occupancy and decode dispatch counts."""
        c, s = self.cache, self.sched
        per_page = sum(int(np.prod((p.shape[0],) + tuple(p.shape[2:])))
                       * p.element_size() for p in c.pools.values())
        return {
            "prefix_cache": self.prefix_cache,
            "prefix_hit_rate": round(c.prefix_hit_rate(), 4),
            "prefix_hit_tokens": c.prefix_hit_tokens,
            "prefix_query_tokens": c.prefix_query_tokens,
            "cow_copies": c.cow_copies,
            "evictions": c.evictions,
            "preemptions": s.preemptions,
            "cached_blocks": c.cached_blocks,
            "free_blocks": c.free_blocks,
            "blocks_in_use": c.blocks_in_use,
            "peak_blocks_in_use": c.peak_blocks_in_use,
            "utilization": round(c.utilization(), 4),
            "admitted": s.admitted,
            "finished": s.finished,
            "finish_reasons": dict(self.finish_reasons),
            "steps": self.steps,
            "decode_tokens": self.decode_tokens,
            "decode_dispatches": self.decode_dispatches,
            "tokens_per_dispatch": round(
                self.decode_tokens / max(self.decode_dispatches, 1), 3),
            "truncated_tokens": self.truncated_tokens,
            "reclaimed_pages": self.reclaimed_pages,
            "state_footprint_bytes": int(c.blocks_in_use * per_page),
        }


class Engine:
    """Dense-slot batched engine (the reference launcher's default).

    Requests are served ``batch_size`` at a time against stacked dense
    caches of ``max_len`` columns: one whole-prompt prefill per batch
    (prompts left-padded to the longest, pad columns masked out of every
    key set, per-lane logical positions), then one decode step per token
    with the shared physical write column. The final ragged chunk of a
    trace is padded to ``batch_size`` with zero-prompt, zero-budget lanes;
    in SOLE mode those lanes and the pad rows take part in every norm's
    batch-global calibration, exactly as in the reference. Finished lanes
    feed token 0 and are never sampled again; when every real lane has
    finished the decode loop exits. Each lane samples on the device from
    its counter-keyed stream (:func:`sample_tokens`, the draw the
    reference's host ``Sampler`` makes); only the (B,) ids come to the
    host.

    Dense family only; moe, ssm and hybrid raise (ROADMAP.md queue 1
    item 7), as do mesh rules (item 9).
    """

    def __init__(self, cfg: ArchConfig, params, *, batch_size: int = 4,
                 max_len: int = 256, device="cuda", rules=None):
        device = _resolve_device(device, "Engine")
        if cfg.family not in ("dense", "moe", "ssm", "hybrid"):
            raise ValueError(f"Engine serves LM families, got {cfg.family}")
        if cfg.family != "dense":
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported yet (ROADMAP.md "
                "queue 1 item 7)")
        if rules is not None:
            raise NotImplementedError(
                "sharding rules are not ported yet (ROADMAP.md queue 1 "
                "item 9)")
        self.cfg = cfg
        self.device = device
        self.params = _serving_params(cfg, params, device)
        self.batch = batch_size
        self.max_len = max_len
        # why each request of the last generate() call stopped, parallel
        # to its returned outputs
        self.finish_reasons: List[str] = []
        self.prefill_calls = 0
        self.decode_calls = 0

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _sample(self, logits: torch.Tensor, samplers: List[Sampler],
                live: List[bool]) -> np.ndarray:
        """(B,) ids drawn on the device from (B, padded_vocab) logits, each
        live lane at its sampler's next counter, which then advances as
        the host ``Sampler`` call would (greedy lanes consume no draw)."""
        lanes = [s for s, on in zip(samplers, live) if on]
        use_top_k = any(s.top_k > 0 for s in lanes)
        stochastic = any(not s.greedy for s in lanes)
        streams = [(s.temperature, s.top_k, s.seed, s.draws)
                   for s in samplers]
        toks = sample_tokens(
            logits, *_sampling_tensors(streams, use_top_k, stochastic,
                                       self._tensor),
            self.cfg.vocab_size, use_top_k=use_top_k, stochastic=stochastic)
        for s, on in zip(samplers, live):
            if on and not s.greedy:
                s.skip(1)
        return toks.cpu().numpy()

    def generate(self, requests: List[Request]) -> List[List[int]]:
        """Serve all requests, ``batch_size`` at a time; outputs in request
        order, ``finish_reasons`` parallel to them ("eos", "stop" or
        "length")."""
        outs: List[List[int]] = []
        self.finish_reasons = []
        for i in range(0, len(requests), self.batch):
            res, reasons = self._generate_batch(requests[i:i + self.batch])
            outs.extend(res)
            self.finish_reasons.extend(reasons)
        return outs

    def _generate_batch(self, chunk: List[Request]
                        ) -> Tuple[List[List[int]], List[str]]:
        real = len(chunk)
        pad = Request(prompt=np.zeros(1, np.int32), max_new_tokens=0)
        chunk = chunk + [pad] * (self.batch - real)
        b = len(chunk)
        samplers = [sampler_for(r, self.cfg.vocab_size) for r in chunk]
        plen = max(len(r.prompt) for r in chunk)
        toks = np.zeros((b, plen), np.int32)
        n_pad = np.zeros((b,), np.int32)
        for j, r in enumerate(chunk):
            toks[j, plen - len(r.prompt):] = r.prompt      # left-pad
            n_pad[j] = plen - len(r.prompt)
        logits, cache = api.prefill(self.params, self._tensor(toks),
                                    self.cfg, self.max_len,
                                    n_pad=self._tensor(n_pad))
        self.prefill_calls += 1
        first = self._sample(logits[:, -1], samplers,
                             [j < real for j in range(b)])
        results: List[List[int]] = [[] for _ in range(b)]
        reasons: List[Optional[str]] = [None] * b
        for j in range(real):
            _, reasons[j] = apply_finish(samplers[j], results[j], [first[j]])

        def live(j: int) -> bool:
            return (j < real and reasons[j] is None
                    and len(results[j]) < chunk[j].max_new_tokens)

        token = np.array([results[j][-1] if live(j) else 0
                          for j in range(b)], np.int32)
        max_new = max(r.max_new_tokens for r in chunk)
        pos = plen                       # shared physical write column
        for _ in range(max_new - 1):
            if not any(live(j) for j in range(b)):
                break                    # early exit: all lanes finished
            logits, cache = api.decode_step(
                self.params, cache, self._tensor(token),
                self._tensor((pos - n_pad).astype(np.int32)), self.cfg,
                write_pos=pos)
            self.decode_calls += 1
            drawn = self._sample(logits, samplers, [live(j) for j in range(b)])
            token = np.zeros((b,), np.int32)
            for j in range(b):
                if live(j):
                    _, reasons[j] = apply_finish(samplers[j], results[j],
                                                 [drawn[j]])
                    if live(j):
                        token[j] = results[j][-1]
            pos += 1
        return results[:real], [r or "length" for r in reasons[:real]]
