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

The recurrent families (ssm: rwkv6; hybrid: RecurrentGemma) keep their
per-sequence state in a ``StateSlotPool`` (serve/state.py): the paged
engine zero-fills or checkpoint-restores a sequence's slot at admission
and, with prefix caching, snapshots it to host memory at block-aligned
prefill boundaries inside the prompt; the hybrid also pages its attention
blocks' K/V.

The encoder-decoder family (encdec: whisper) is served by the paged engine
only: each request carries its encoder frames (``Request.frames``), the
encoder runs once at admission and parks every decoder layer's cross K/V
in pages the scheduler reserved beside the self-attention pages; a
preempted request re-encodes on re-admission. The vlm family is not
paged-servable and neither engine serves it (its ``prefill``/``decode_step``
are reached through ``models.api``).

``PagedEngine(rules=, param_axes=)`` and ``Engine(rules=, param_axes=)``
serve the dense and MoE families over a (D, M) mesh of
``torch.distributed`` ranks (``launch/mesh.py``): each rank runs the
engine on the same requests with its slice of the weights
(``convert.shard_params``: split over the model axis, whole over data but
for the MoE experts, which lie over it: ``models/moe.py``'s routes) and
of every KV page's heads (``PagedKVCache``
at the rank's shape, every page on every data rank); the layers call the
collectives (``models/layers.py``). Over the data axis a dispatch's lanes
split where D divides them (a decode or verify batch, a dense-slot
batch; a B = 1 prefill chunk replicates): each data rank runs its lanes,
SOLE's norms calibrate over the whole batch, every lane's new K/V rows
reach every data rank's pool and the draws are gathered. Page tables,
refcounts, the prefix index and the scheduler are host state, identical
on every rank. Every value a rank's host acts on (the sampled tokens, a
prefill's logits row) is replicated after the gathers, and each readback
checks that every rank of the mesh holds the same bytes
(``sharding.comm.agreed``): a rank whose tokens parted would
desynchronise the schedulers, so it fails at once instead.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import ArchConfig
from repro_torch.convert import shard_params, shard_shape
from repro_torch.core.sole.quant import is_qtensor
from repro_torch.models import api
from repro_torch.models.state import tree_map
from repro_torch.serve.kv_cache import PagedKVCache, copy_pages
from repro_torch.serve.sampling import (Sampler, apply_finish, eos_table,
                                        sample_tokens, sampler_for)
from repro_torch.serve.scheduler import Scheduler, Sequence
from repro_torch.serve.state import StateCheckpointCache, StateSlotPool
from repro_torch.sharding import comm
from repro_torch.sharding.rules import (QUANT_WEIGHT_SPEC, quantize_param_axes,
                                        quantize_params, use_rules)


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
    # encdec only: the encoder input (S_enc, D) or (1, S_enc, D), run once
    # per admission.
    frames: Optional[np.ndarray] = None


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


def _host(t: torch.Tensor) -> np.ndarray:
    """A whole device array to host memory in one copy: with
    :meth:`PagedEngine._tensor`'s uploads, the engines' only transfers
    (``analysis/sanitizers.py`` allows these and no other sync)."""
    return t.cpu().numpy()


def _to_host(toks: torch.Tensor, done: torch.Tensor, host=_host):
    """(B, W) draws and eos mask -> numpy (int32, bool), in one copy."""
    w = toks.shape[1]
    out = host(torch.cat([toks, done.to(torch.int32)], 1))
    return out[:, :w], out[:, w:].astype(bool)


def _check_family(cfg: ArchConfig, engine: str) -> None:
    """Quantized serving: only the dense and MoE families have a path, as
    in the reference. MoE under int8 weights has no reference to hold it
    to (the JAX package's MoE FFN casts the packed expert leaves and
    fails), so it raises too."""
    if cfg.family not in ("dense", "moe") and cfg.quant.weights:
        raise ValueError(
            f"family {cfg.family!r} has no quantized serving path "
            "(quant.weights is dense/moe-only)")
    if cfg.family == "moe" and cfg.quant.weights:
        raise NotImplementedError(
            f"{engine}: MoE with quant mode {cfg.quant.mode!r}: the "
            "reference has no quantized MoE path (repro/models/moe.py:155-156 "
            "casts the packed expert weights and fails), so the port has "
            "none")


class ShardedTree(dict):
    """A parameter tree already laid out for one rank of a mesh
    (``layout`` = (rules, rank)): replica engines sharing it take it as
    it is."""

    layout: tuple = ()


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _check_rules(cfg: ArchConfig, rules, engine: str) -> None:
    """Mesh rules: the dense and MoE families over a (D, M) mesh of every
    rank of the process group. The families with no port under rules yet
    raise, naming their ``ROADMAP.md`` item."""
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"{engine}: mesh rules on the {cfg.family!r} family are not "
            "ported yet (ROADMAP.md queue 1 item 9.2b: the recurrent, "
            "encdec and vlm families under rules)")
    n = math.prod(rules.axis_sizes.values())
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n != world:
        raise ValueError(f"{engine}: a mesh of {n} ranks "
                         f"{dict(rules.axis_sizes)} in a process group of "
                         f"{world}")


def _serving_params(cfg: ArchConfig, params, device, rules=None,
                    axes=None):
    """The engine's parameter tree on ``device``: under ``cfg.quant.weights``
    every matmul weight packed to int8 + per-channel scales, as the
    reference engines do (idempotent), from float32 masters only (codes
    packed from bf16 would differ); under ``rules`` then this rank's slice
    of each leaf per ``axes`` (``models.api.param_axes(cfg)`` by default;
    packing comes first, so each scale covers the whole contraction),
    packed and cut where ``params`` lie: a tree in host memory puts only
    the rank's slices on ``device``."""
    if rules is not None:
        layout = (rules, _rank())
        if isinstance(params, ShardedTree) and params.layout == layout:
            return params
    if cfg.quant.weights:
        _check_float32_masters(params)
        params = quantize_params(params)
    if rules is None:
        return tree_map(lambda t: t.to(device), params)
    axes = api.param_axes(cfg) if axes is None else axes
    if cfg.quant.weights:
        axes = quantize_param_axes(axes)
    out = ShardedTree(tree_map(lambda t: t.to(device),
                               shard_params(params, axes, rules,
                                            layout[1])))
    out.layout = layout
    return out


class PagedEngine:
    """Continuous-batching engine over paged **sequence state** for the
    dense, MoE, encdec, ssm and hybrid families (MoE routing drop-free, so
    each lane's tokens are its dense oracle's). The family's
    ``SequenceStateSpec`` says which pools its state lives in (KV pages,
    recurrent state slots) and which features are legal; an unsupported
    feature raises at construction.

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

    With ``spec_config`` (serve/spec.py) a step first tries one
    speculative round: the drafter proposes up to K tokens per lane and
    one ``verify_paged`` dispatch scores all K + 1 positions and draws the
    pinned tokens; the longest draft prefix equal to them is kept, the
    rejected tail's pages are handed back at once. When no lane drafts
    the step takes the decode horizon.

    Encdec requests carry encoder frames: at admission the encoder runs
    once (one request at a time) and writes every decoder layer's cross
    K/V into the request's cross pages, which each prefill chunk and decode
    horizon reads (null lanes claim one valid cross row).

    With ``rules`` (a (D, M) mesh's ``sharding.rules.Rules``) the engine
    is one rank of a dense or MoE model served over the mesh (module
    docstring):
    it keeps this rank's slice of the weights (``param_axes`` their
    logical axes, ``models.api.param_axes(cfg)`` by default; a
    ``ShardedTree`` of another engine on the same rules is taken as it is;
    pass ``params`` in host memory, so that the card never holds the whole
    tree) and of the KV pages (allocated at the slice's shape, whole over
    data), runs its data rank's share of each decode or verify dispatch's
    lanes, and every step runs under the rules.

    Features without a path raise here rather than being silently
    downgraded: the vlm family (not paged-servable), int8 weights on every
    family but dense, int8 KV pages on encdec (the reference reads its int8
    cross pages undequantized) and mesh rules on any family but dense and
    MoE.
    """

    def __init__(self, cfg: ArchConfig, params, *, num_blocks: int = 64,
                 block_size: int = 16, max_seq_len: int = 256,
                 max_running: int = 8, decode_batch: int = 4,
                 prefill_chunk: int = 16, decode_horizon: int = 8,
                 device="cuda", prefix_cache: Optional[bool] = None,
                 watermark: int = 1, rules=None, param_axes=None,
                 spec_config=None):
        device = _resolve_device(device, "PagedEngine")
        if rules is not None:
            _check_rules(cfg, rules, "PagedEngine")
        _check_family(cfg, "PagedEngine")
        state_spec = api.sequence_state_spec(cfg)
        if not state_spec.servable:
            raise ValueError(
                f"family {cfg.family!r} is not paged-servable "
                "(see its sequence_state_spec)")
        if state_spec.cross_tokens and cfg.kv_cache_dtype == "int8":
            raise NotImplementedError(
                "PagedEngine: encdec with int8 KV pages: the reference "
                "writes the cross pages as int8 codes and reads them back "
                "cast, not dequantized (repro/models/whisper.py:318-320), "
                "so its tokens part from its own dense oracle; the port has "
                "no such path")
        if cfg.window and max_seq_len > cfg.window:
            raise ValueError(
                "pages are append-only: serving past the sliding window "
                f"(max_seq_len {max_seq_len} > window {cfg.window}) would "
                "keep dead KV resident; cap max_seq_len at the window")
        if prefix_cache is None:
            prefix_cache = state_spec.supports_prefix_cache
        elif prefix_cache and not state_spec.supports_prefix_cache:
            raise ValueError(
                f"family {cfg.family!r} does not support prefix caching "
                "(its sequence state cannot be restored at a matched "
                "boundary)")
        if spec_config is not None:
            if not state_spec.supports_spec_decode:
                raise ValueError(
                    f"family {cfg.family!r} does not support speculative "
                    "decoding (its sequence state cannot rewind rejected "
                    "drafts)")
            # acceptance compares draft ids with draws over cfg.vocab_size
            dv = getattr(spec_config.drafter, "vocab_size", None)
            if dv is not None and dv != cfg.vocab_size:
                raise ValueError(
                    f"drafter vocab {dv} != target vocab {cfg.vocab_size}: "
                    "speculation needs a shared tokenizer")
        if decode_horizon < 1:
            raise ValueError(
                f"decode_horizon must be >= 1, got {decode_horizon}")
        self.cfg = cfg
        self.device = device
        self.state_spec = state_spec
        self.prefix_cache = prefix_cache
        self.rules = rules
        self._mesh = comm.whole_mesh(rules)
        self.params = _serving_params(cfg, params, device, rules, param_axes)
        self.decode_batch = decode_batch
        self.decode_horizon = decode_horizon
        # always built: a pure-recurrent family gets zero-byte pools with
        # every host-side invariant intact
        self.cache = PagedKVCache(cfg, num_blocks=num_blocks,
                                  block_size=block_size,
                                  max_seq_len=max_seq_len,
                                  prefix_cache=(prefix_cache
                                                and state_spec.has_pages),
                                  device=device,
                                  kv_layers=state_spec.kv_layers,
                                  rules=rules)
        # recurrent families: one state slot per running lane (+ the null
        # slot) and, with prefix caching, the block-boundary checkpoints
        # that stand in for page sharing
        self.slot_pool = None
        self.ckpts = None
        if state_spec.has_slots:
            self.slot_pool = StateSlotPool(state_spec,
                                           num_slots=max_running + 1,
                                           device=device)
            if prefix_cache:
                self.ckpts = StateCheckpointCache(block_size=block_size)
        self.sched = Scheduler(self.cache, max_running=max_running,
                               prefill_chunk=prefill_chunk,
                               watermark=watermark, spec=state_spec,
                               slots=self.slot_pool, ckpts=self.ckpts)
        self.spec = spec_config
        self.finish_reasons: Dict[str, int] = {}
        self._finished: Dict[int, List[int]] = {}
        self.reset_stats()

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _host(self, t: torch.Tensor) -> np.ndarray:
        """:func:`_host`; under mesh rules after checking that every rank
        of the mesh reads the same bytes (one gather)."""
        return comm.agreed(t, self._mesh, "PagedEngine readback")

    def _apply_copies(self, copies: List[Tuple[int, int]]) -> None:
        """Replay COW page duplications on the device before the step
        that writes into the fresh private pages."""
        if not copies:
            return
        src, dst = zip(*copies)
        copy_pages(self.cache.pools, self._tensor(np.array(src, np.int64)),
                   self._tensor(np.array(dst, np.int64)))

    def _refs(self, seqs: List[Optional[Sequence]]) -> Dict[str, torch.Tensor]:
        """Page tables, slot ids and/or cross-page tables for a padded
        batch; ``None`` lanes get the null page row and the null slot."""
        sids = [s.seq_id if s is not None else None for s in seqs]
        spec = self.state_spec
        refs = {}
        if spec.has_pages:
            refs["tables"] = self._tensor(self.cache.batch_tables(sids))
        if self.slot_pool is not None:
            refs["slots"] = self._tensor(self.slot_pool.batch_slots(sids))
        if spec.cross_tokens:
            cb = self.cache.blocks_for_tokens(spec.cross_tokens)
            refs["cross"] = self._tensor(self.cache.batch_cross(sids, cb))
            # null lanes claim one valid cross row: they attend one garbage
            # null-page key rather than an all-masked row
            refs["cross_valid"] = self._tensor(np.array(
                [s.cross_valid if s is not None else 1 for s in seqs],
                np.int32))
        return refs

    # -- composite sequence state ---------------------------------------------

    def _state(self) -> Dict[str, object]:
        """The family's device state for one model call: the page pools
        and/or the slot tree, keyed as ``models.api`` expects."""
        st: Dict[str, object] = (dict(self.cache.pools)
                                 if self.state_spec.has_pages else {})
        if self.slot_pool is not None:
            st["slots"] = self.slot_pool.slots
        return st

    def _put_state(self, state: Dict[str, object]) -> None:
        if self.state_spec.has_pages:
            self.cache.pools = {"k": state["k"], "v": state["v"]}
        if self.slot_pool is not None:
            self.slot_pool.slots = state["slots"]

    def _init_state(self, seq: Sequence) -> None:
        """Once per admission, before the first prefill chunk: zero-fill
        the sequence's slot (its contents are the previous owner's) or
        load the host checkpoint the scheduler matched; encdec: run the
        encoder on the request's frames, parking the cross K/V in the
        pages the scheduler reserved."""
        if seq.state_ready:
            return
        if self.slot_pool is not None:
            i = self.slot_pool.slot_of(seq.seq_id)
            if seq._restore is not None:
                tree_map(lambda s, v: s[i].copy_(v), self.slot_pool.slots,
                         seq._restore)
                seq._restore = None
            else:
                tree_map(lambda s: s[i].zero_(), self.slot_pool.slots)
        spec = self.state_spec
        if spec.cross_tokens:
            if seq.frames is None:
                raise ValueError(
                    f"family {self.cfg.family!r} needs encoder frames on "
                    "every request (Request.frames)")
            frames = np.asarray(seq.frames, np.float32)
            if frames.ndim == 2:
                frames = frames[None]
            seq.cross_valid = max(1, min(frames.shape[1], spec.cross_tokens))
            cb = self.cache.blocks_for_tokens(spec.cross_tokens)
            row = self.cache.cross_row(seq.seq_id, cb)[None]
            self._put_state(api.encode_paged(
                self.params, self._tensor(frames), self._tensor(row),
                self._state(), self.cfg))
        seq.state_ready = True

    def _maybe_checkpoint(self, seq: Sequence, boundary: int) -> None:
        """After a prefill chunk ending at ``boundary`` replay tokens: copy
        the slot to host memory and register it under the prompt's chain
        keys, iff the boundary is block-aligned and strictly inside the
        prompt (the final position is always recomputed)."""
        if self.ckpts is None or seq.prefix_keys is None:
            return
        if (boundary % self.cache.block_size != 0 or boundary <= 0
                or boundary > seq.prompt_len - 1):
            return
        i = self.slot_pool.slot_of(seq.seq_id)
        self.ckpts.register(seq.prefix_keys, boundary,
                            tree_map(lambda s: s[i].to("cpu", copy=True),
                                     self.slot_pool.slots))

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
        self._init_state(seq)
        chunk = np.zeros((1, c), np.int32)
        chunk[0, :real] = replay[start:start + real]
        logits, state = api.prefill_paged(
            self.params, self._tensor(chunk),
            self._tensor(np.array([start], np.int32)),
            self._tensor(np.array([real], np.int32)), self._refs([seq]),
            self._state(), self.cfg)
        self._put_state(state)
        seq.prefilled = start + real
        self._maybe_checkpoint(seq, start + real)
        if not seq.in_prefill:
            if self.state_spec.has_pages:
                self.cache.register_prompt(seq.seq_id, seq.prompt,
                                           seq.prefix_keys)
            if not seq.out:
                # fresh sequence: the first generated token comes from the
                # last real prompt position's logits (a resumed sequence
                # already holds its next feed token in out).
                tok = seq.sampler(self._host(logits[0, real - 1]))
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
        sampling, flags = self._lane_sampling(lanes)
        toks, done, state = api.decode_horizon_paged(
            self.params, self._tensor(token), self._tensor(pos),
            self._refs(seqs), self._state(), *sampling, self.cfg,
            num_steps=h, **flags)
        self._put_state(state)
        rows, done_rows = _to_host(toks, done, self._host)
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

    def _lane_sampling(self, lanes: List[Sequence]):
        """The (temperature, top_k, seed, counter, eos table) device
        tensors of a padded batch whose first lanes are ``lanes``, and the
        flags of the sampling fast paths. Skipping the rank sort / the
        Gumbel rows / the eos test is an identity for lanes that use no
        top-k / temperature / eos ids, so the flags come from the live
        lanes (an all-greedy batch ships no sampling tensors at all).
        Token n of a sequence draws with counter n: the host sampler spent
        counter 0 on the prefill-logits token, so the device stream
        continues where it left off; null lanes are greedy."""
        d = self.decode_batch
        widest = max(len(s.sampler.eos_ids) for s in lanes)
        use_eos = widest > 0
        eos = np.full((d, 1), -1, np.int32)
        if use_eos:
            eos = np.full((d, widest), -1, np.int32)
            eos[:len(lanes)] = eos_table([s.sampler for s in lanes], widest)
        use_top_k = any(s.sampler.top_k > 0 for s in lanes)
        stochastic = any(not s.sampler.greedy for s in lanes)
        streams = [(s.sampler.temperature, s.sampler.top_k, s.sampler.seed,
                    len(s.out)) for s in lanes]
        streams += [(0.0, 0, 0, 0)] * (d - len(lanes))
        tensors = (*_sampling_tensors(streams, use_top_k, stochastic,
                                      self._tensor), self._tensor(eos))
        return tensors, dict(use_top_k=use_top_k, stochastic=stochastic,
                             use_eos=use_eos)

    def _spec_step(self) -> bool:
        """One speculative round: draft K tokens per lane, score all K + 1
        positions in one ``verify_paged`` dispatch, keep the longest draft
        prefix equal to the pinned draws.

        Returns False when speculation does not apply this step (no spec
        config, a pending prefill, every lane's controller at K = 0, or no
        proposal) and the caller takes the decode horizon. Per lane (draft
        length k, verify width k + 1): ``acc`` is the accepted prefix; the
        emitted row is the pinned draws ``rows[:acc + 1]`` (accepted
        tokens and the correction or bonus), cut by ``apply_finish`` at the
        first eos/stop event as in the horizon; the host counter advances
        by the kept count only and ``truncate`` hands back every page past
        the kept K/V.
        """
        if self.spec is None:
            return False
        batch = self.sched.decode_batch(self.decode_batch)
        if not batch or any(s.in_prefill for s in self.sched.running):
            return False
        ks = self.sched.spec_ks(batch, self.spec)
        if max(ks) == 0:
            self.spec_fallbacks += 1
            return False
        drafts = self.spec.drafter.propose(batch, ks)
        drafts = [[int(t) for t in d[:k]] for d, k in zip(drafts, ks)]
        if not any(drafts):
            self.spec_fallbacks += 1
            return False
        # verify width C = K + 1 with K a power of two, as the reference
        # compiles it (a handful of shapes)
        c = (1 << (max(len(d) for d in drafts) - 1).bit_length()) + 1
        lanes: List[Tuple[Sequence, List[int]]] = []
        for seq, draft in zip(batch, drafts):
            if seq not in self.sched.running:
                continue                 # preempted by an earlier lane
            pos = seq.prompt_len + len(seq.out) - 1
            # pre-extend for the feed token and every draft token
            copies = self.sched.ensure_tokens(seq, pos, pos + 1 + len(draft))
            if copies is None:
                continue
            self._apply_copies(copies)
            lanes.append((seq, draft))
        assert all(s in self.sched.running for s, _ in lanes)
        if not lanes:
            return True                  # everything preempted this step
        d = self.decode_batch
        tokens = np.zeros((d, c), np.int32)
        q_start = np.zeros((d,), np.int32)
        # null lanes write (and read) one token on the null page
        n_valid = np.ones((d,), np.int32)
        seqs: List[Optional[Sequence]] = [None] * d
        for i, (seq, draft) in enumerate(lanes):
            row = [seq.out[-1]] + draft
            tokens[i, :len(row)] = row
            q_start[i] = seq.prompt_len + len(seq.out) - 1
            n_valid[i] = len(row)
            seqs[i] = seq
        sampling, flags = self._lane_sampling([s for s, _ in lanes])
        pinned, done, state = api.verify_paged(
            self.params, self._tensor(tokens), self._tensor(q_start),
            self._tensor(n_valid), self._refs(seqs), self.cache.pools,
            *sampling, self.cfg, **flags)
        self.cache.pools = state
        rows, done_rows = _to_host(pinned, done, self._host)
        for i, (seq, draft) in enumerate(lanes):
            acc = 0
            while acc < len(draft) and draft[acc] == rows[i, acc]:
                acc += 1
            kept, reason = apply_finish(seq.sampler, seq.out,
                                        rows[i, :acc + 1],
                                        eos_row=done_rows[i, :acc + 1])
            seq.sampler.skip(kept)       # the host stream stays aligned
            pos = int(q_start[i])
            seq.prefilled = pos + kept   # valid written K/V only
            self.decode_tokens += kept
            self.truncated_tokens += 1 + len(draft) - kept
            self.spec_proposed += len(draft)
            self.spec_accepted += acc
            self.sched.spec_feedback(seq, len(draft), acc, self.spec)
            if reason is not None:
                seq.finish_reason = reason
            # the rejected (and finish) tail's pre-extended pages go back
            self.reclaimed_pages += self.cache.truncate(seq.seq_id,
                                                        pos + kept)
        self.decode_dispatches += 1
        self.spec_dispatches += 1
        return True

    def _reap_done(self) -> None:
        for seq in list(self.sched.running):
            if seq.done:
                seq.finish_reason = seq.finish_reason or "length"
                self.finish_reasons[seq.finish_reason] = (
                    self.finish_reasons.get(seq.finish_reason, 0) + 1)
                self._finished[seq.seq_id] = seq.out
                self.sched.finish(seq)

    def step(self) -> None:
        """One engine iteration: admit, one prefill chunk, one speculative
        round or else one decode horizon for the running batch, reclaim
        finished sequences (also right after the prefill, so their pages
        fund the decode batch's growth). The step enters the engine's
        rules, so every caller (``generate()``, the async loop, an
        external loop) runs the tensor-parallel layers."""
        with use_rules(self.rules):
            self.sched.admit()
            seq = self.sched.next_prefill()
            if seq is not None:
                self._prefill_step(seq)
            self._reap_done()
            if not self._spec_step():
                self._decode_step()
            self._reap_done()
        self.steps += 1

    # -- public API -----------------------------------------------------------

    def submit(self, request: Request) -> Sequence:
        """Validate and queue one request; returns its live Sequence."""
        if self.state_spec.cross_tokens and request.frames is None:
            raise ValueError(
                f"family {self.cfg.family!r} needs encoder frames on "
                "every request (Request.frames)")
        return self.sched.submit(
            request.prompt, request.max_new_tokens,
            sampler=sampler_for(request, self.cfg.vocab_size),
            frames=request.frames)

    def cancel(self, seq: Sequence) -> bool:
        """Cancel a submitted sequence, a finish event like any other:
        counted in ``stats()["finish_reasons"]``, its pages released by
        the scheduler (a running lane is reaped at once, a waiting one
        leaves the queue). False if it already finished."""
        if not self.sched.cancel(seq):
            return False
        self.finish_reasons["cancelled"] = (
            self.finish_reasons.get("cancelled", 0) + 1)
        return True

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
        out = {
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
            "cancelled": s.cancelled,
            "finish_reasons": dict(self.finish_reasons),
            "steps": self.steps,
            "decode_tokens": self.decode_tokens,
            "decode_dispatches": self.decode_dispatches,
            "tokens_per_dispatch": round(
                self.decode_tokens / max(self.decode_dispatches, 1), 3),
            "truncated_tokens": self.truncated_tokens,
            "reclaimed_pages": self.reclaimed_pages,
        }
        # the state footprint: live pages and live slots, what admission
        # and preemption manage (O(1) per sequence for a recurrent family)
        foot = c.blocks_in_use * per_page
        if self.slot_pool is not None:
            sp = self.slot_pool
            foot += sp.slots_in_use * sp.bytes_per_slot
            out.update({
                "state_slots_in_use": sp.slots_in_use,
                "free_state_slots": sp.free_slots,
                "peak_state_slots_in_use": sp.peak_slots_in_use,
                "state_bytes_per_slot": sp.bytes_per_slot,
            })
            if self.ckpts is not None:
                cs = self.ckpts.stats()
                out["state_checkpoints"] = cs["entries"]
                out["checkpoint_hit_tokens"] = cs["hit_tokens"]
        out["state_footprint_bytes"] = int(foot)
        if self.spec is not None:
            # verify dispatches count as decode dispatches and only kept
            # tokens count, so tokens per target dispatch is
            # tokens_per_dispatch under speculation
            out.update({
                "spec_dispatches": self.spec_dispatches,
                "spec_proposed_tokens": self.spec_proposed,
                "spec_accepted_tokens": self.spec_accepted,
                "spec_fallback_steps": self.spec_fallbacks,
                "acceptance_rate": round(
                    self.spec_accepted / max(self.spec_proposed, 1), 4),
                "accepted_tokens_per_target_dispatch": round(
                    self.decode_tokens / max(self.decode_dispatches, 1), 3),
            })
        return out

    def reset_stats(self) -> None:
        """Zero the serving counters (cached pages stay resident)."""
        self.cache.reset_stats()
        if self.slot_pool is not None:
            self.slot_pool.reset_stats()
        s = self.sched
        s.preemptions = s.admitted = s.finished = s.cancelled = 0
        self.steps = 0
        self.decode_tokens = 0
        self.decode_dispatches = 0
        self.truncated_tokens = 0        # horizon/verify-tail draws discarded
        self.reclaimed_pages = 0         # pages handed back by truncate
        self.spec_dispatches = 0         # verify dispatches issued
        self.spec_proposed = 0           # draft tokens sent to verify
        self.spec_accepted = 0           # draft tokens accepted
        self.spec_fallbacks = 0          # steps speculation handed back
        self.finish_reasons = {}


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

    The dense and MoE families (MoE with the capacity-factor formula,
    so tokens can drop, as in the reference) thread per-lane positions, so
    left-padded lanes mask their pad columns; the recurrent families (ssm,
    hybrid) keep the reference's shared positions: pad tokens run through
    the recurrence, so parity batches use equal-length prompts. Encdec and
    vlm are not LM families and raise, as in the reference, as do int8
    weights on MoE and the recurrent families, and int8 KV on the hybrid's
    dense caches (the reference stores a cast there, with no scale).

    With ``rules`` (a (D, M) mesh's, dense and MoE families, as
    ``PagedEngine``'s) the engine is one rank of the model served over the
    mesh: this rank's slice of the weights (``param_axes`` as
    ``PagedEngine``'s), the dense caches at the rank's shape by
    ``models.api.cache_axes`` (lanes over data where D divides the batch,
    KV heads over model where they divide it; checked at the first
    prefill), each call's lanes split over data with every lane's logits
    gathered, the attention in the paged plan's regime (matched,
    replicated KV, heads replicated) and each readback checked equal on
    every rank. MoE's capacity-factor formula counts the tokens a rank
    dispatches: its lanes where the data axis splits the batch (expert
    parallelism, as the reference's formula inside ``shard_map``), so the
    tokens it drops there can differ from one card's.
    """

    def __init__(self, cfg: ArchConfig, params, *, batch_size: int = 4,
                 max_len: int = 256, device="cuda", rules=None,
                 param_axes=None):
        device = _resolve_device(device, "Engine")
        if cfg.family not in ("dense", "moe", "ssm", "hybrid"):
            raise ValueError(f"Engine serves LM families, got {cfg.family}")
        _check_family(cfg, "Engine")
        if rules is not None:
            _check_rules(cfg, rules, "Engine")
        if cfg.family == "hybrid" and cfg.kv_cache_dtype == "int8":
            raise NotImplementedError(
                "Engine: int8 KV on the hybrid's dense caches: the "
                "reference's decode_attend stores a cast of K/V there, with "
                "no scale, so the port has no such path (PagedEngine pages "
                "int8 KV)")
        self.cfg = cfg
        self.device = device
        self.rules = rules
        self._mesh = comm.whole_mesh(rules)
        self._cache_checked = rules is None
        self.params = _serving_params(cfg, params, device, rules, param_axes)
        self.batch = batch_size
        self.max_len = max_len
        # attention-cache families thread per-lane positions through prefill
        # and decode; the recurrent families keep shared positions
        self._lane_pos = cfg.family in ("dense", "moe")
        # why each request of the last generate() call stopped, parallel
        # to its returned outputs
        self.finish_reasons: List[str] = []
        self.prefill_calls = 0
        self.decode_calls = 0

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _host(self, t: torch.Tensor) -> np.ndarray:
        """As ``PagedEngine._host``."""
        return comm.agreed(t, self._mesh, "Engine readback")

    def _check_cache(self, cache, b: int) -> None:
        """Under rules, once: the dense caches hold the rank's shard of
        ``models.api.cache_axes`` (its lanes and KV heads)."""
        axes = api.cache_axes(self.cfg)
        for key in ("k", "v"):
            t = cache[key]             # (L, B, KV, ...) of the whole batch
            whole = ((t.shape[0], b, self.cfg.n_kv_heads)
                     + tuple(t.shape[3:]))
            want = shard_shape(self.rules.spec(axes[key], whole), whole,
                               self.rules)
            if tuple(t.shape) != tuple(want):
                raise AssertionError(
                    f"Engine: cache {key!r} {tuple(t.shape)} is not the "
                    f"rank's shard {tuple(want)} of {whole}")
        self._cache_checked = True

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
        return self._host(toks)

    def generate(self, requests: List[Request]) -> List[List[int]]:
        """Serve all requests, ``batch_size`` at a time; outputs in request
        order, ``finish_reasons`` parallel to them ("eos", "stop" or
        "length")."""
        outs: List[List[int]] = []
        self.finish_reasons = []
        with use_rules(self.rules):
            for i in range(0, len(requests), self.batch):
                res, reasons = self._generate_batch(
                    requests[i:i + self.batch])
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
        logits, cache = api.prefill(
            self.params, self._tensor(toks), self.cfg, self.max_len,
            n_pad=self._tensor(n_pad) if self._lane_pos else None)
        self.prefill_calls += 1
        if not self._cache_checked:
            self._check_cache(cache, b)
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
            if self._lane_pos:
                logits, cache = api.decode_step(
                    self.params, cache, self._tensor(token),
                    self._tensor((pos - n_pad).astype(np.int32)), self.cfg,
                    write_pos=pos)
            else:
                logits, cache = api.decode_step(
                    self.params, cache, self._tensor(token), pos, self.cfg)
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
