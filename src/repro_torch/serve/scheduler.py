"""Admission/preemption scheduler: token-level continuous batching over
a shared-page KV pool.

Requests wait in a FIFO queue. Admission is **optimistic**: a request is
admitted when the pool's drawable capacity (free + evictable pages)
covers the part of its prompt the prefix cache cannot supply, plus a
small watermark; pages are then allocated on demand, one prefill chunk
or decode horizon at a time (:meth:`Scheduler.ensure_tokens`). When a
growth step cannot be covered the youngest running sequence is
**recompute-preempted**: its page references are released and it
re-enters the front of the queue with its generated tokens intact, to
replay ``prompt + out[:-1]`` through chunked prefill on re-admission.
Long prompts are prefilled in fixed-size chunks, one per engine step.

Recurrent families (``spec.has_slots``) also hold one state slot per
running sequence, acquired at admission and released at finish,
cancellation and preemption; with prefix caching on they resume only at a
block boundary a state checkpoint covers (the hybrid: the deepest one its
page match also covers, the unusable page tail dropped).

Encoder-decoder sequences (``spec.cross_tokens``) also hold private cross
pages for their encoder's K/V, reserved at admission on top of the
self-attention pages and dropped at finish, cancellation and preemption
(a preempted sequence re-encodes on re-admission).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, List, Optional, Tuple

import numpy as np

from repro_torch.serve.kv_cache import PagedKVCache
from repro_torch.serve.sampling import Sampler


@dataclasses.dataclass(eq=False)       # identity semantics: sequences are
class Sequence:                        # tracked in running/waiting by object
    """One in-flight request: prompt, progress, outputs, sampler."""
    seq_id: int
    prompt: np.ndarray                 # (prompt_len,) int32
    max_new_tokens: int
    sampler: Optional[Sampler] = None
    prefilled: int = 0                 # replay tokens already written
    out: List[int] = dataclasses.field(default_factory=list)
    restarts: int = 0                  # recompute-preemption count
    # "eos" | "stop" | "cancelled" the moment the event fires (done even
    # mid-prefill); "length" at reap time.
    finish_reason: Optional[str] = None
    # cache.prefix_keys(prompt), computed once at the first admission try.
    prefix_keys: Optional[List[Tuple[int, bytes]]] = None
    # speculative decoding (Scheduler.spec_ks/spec_feedback): the lane's
    # draft length (None before its first round, 0 = back on the plain
    # decode horizon), its EMA acceptance rate, and rounds spent at K = 0
    # waiting for the re-probe.
    spec_k: Optional[int] = None
    spec_ema: float = 1.0
    spec_cool: int = 0
    # recurrent-slot lifecycle: the engine zero-fills or checkpoint-restores
    # the sequence's slot before the first prefill chunk of each admission;
    # _restore holds the host checkpoint tree the scheduler matched, if any.
    state_ready: bool = False
    # encdec only: the raw encoder input, run once per admission (frames
    # cannot be replayed from tokens, so preemption re-encodes), and the
    # encoder rows valid in the cross pages (shorter inputs mask the tail)
    frames: Optional[np.ndarray] = dataclasses.field(default=None,
                                                     repr=False)
    cross_valid: int = 0
    _restore: Optional[object] = dataclasses.field(default=None, repr=False)
    _replay: Optional[np.ndarray] = dataclasses.field(default=None,
                                                      repr=False)

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)

    @property
    def replay_len(self) -> int:
        """Tokens whose KV must exist before the next decode feed: the
        prompt plus every generated token but the one about to be fed."""
        return self.prompt_len + max(len(self.out) - 1, 0)

    @property
    def replay_tokens(self) -> np.ndarray:
        """(replay_len,) token stream a (re-)prefill must write."""
        if self._replay is None or len(self._replay) != self.replay_len:
            if self.out:
                self._replay = np.concatenate(
                    [self.prompt, np.asarray(self.out[:-1], np.int32)])
            else:
                self._replay = self.prompt
        return self._replay

    @property
    def in_prefill(self) -> bool:
        return self.prefilled < self.replay_len

    @property
    def done(self) -> bool:
        """A finish event fired, or the token budget is met."""
        return (self.finish_reason is not None
                or (not self.in_prefill
                    and len(self.out) >= self.max_new_tokens))


class Scheduler:
    """Pairs the waiting queue with the shared-page pool."""

    def __init__(self, cache: PagedKVCache, *, max_running: int,
                 prefill_chunk: int, watermark: int = 1, spec=None,
                 slots=None, ckpts=None):
        self.cache = cache
        # the family's SequenceStateSpec (None: pages only), its
        # StateSlotPool and, with prefix caching on a slot family, the
        # StateCheckpointCache that stands in for page sharing
        self.state_spec = spec
        self.slots = slots
        self.ckpts = ckpts
        self._uses_pages = spec is None or spec.has_pages
        self._cross_blocks = (cache.blocks_for_tokens(spec.cross_tokens)
                              if spec is not None and spec.cross_tokens
                              else 0)
        self.max_running = max_running
        self.prefill_chunk = prefill_chunk
        self.watermark = watermark
        self.waiting: Deque[Sequence] = deque()
        self.running: List[Sequence] = []
        self._next_id = 0
        self.admitted = 0
        self.finished = 0
        self.preemptions = 0
        self.cancelled = 0

    # -- intake ---------------------------------------------------------------

    def check_fits(self, prompt: np.ndarray, max_new_tokens: int) -> None:
        """Raise if this request's footprint can never be allocated."""
        footprint = len(prompt) + max(max_new_tokens - 1, 0)
        need = (self.cache.blocks_for_tokens(footprint)
                if self._uses_pages else 0) + self._cross_blocks
        # cross pages are a fixed overhead beside the max_seq_len budget
        limit = min(self.cache.max_blocks_per_seq + self._cross_blocks,
                    self.cache.num_blocks - 1)
        if need > limit:
            raise ValueError(
                f"request footprint of {need} pages can never fit "
                f"(per-seq/pool limit {limit})")

    def submit(self, prompt: np.ndarray, max_new_tokens: int,
               sampler: Optional[Sampler] = None,
               frames: Optional[np.ndarray] = None) -> Sequence:
        """Queue a request, failing fast if it can never fit."""
        self.check_fits(prompt, max_new_tokens)
        if sampler is None:
            sampler = Sampler(vocab_size=self.cache.cfg.vocab_size)
        seq = Sequence(self._next_id, np.asarray(prompt, np.int32),
                       max_new_tokens, sampler=sampler, frames=frames)
        self._next_id += 1
        self.waiting.append(seq)
        return seq

    def abandon(self, seq_ids) -> None:
        """Drop still-waiting submissions."""
        drop = set(seq_ids)
        self.waiting = deque(s for s in self.waiting
                             if s.seq_id not in drop)

    # -- admission ------------------------------------------------------------

    def admit(self) -> int:
        """FIFO-admit waiting requests while a lane is free and the pool
        can plausibly cover the un-cached prompt tail + watermark; the
        matched prefix pages are attached and the sequence starts
        ``prefilled`` at the cached boundary. With nothing running the
        head request is admitted unconditionally (liveness)."""
        n = 0
        while self.waiting and len(self.running) < self.max_running:
            seq = self.waiting[0]
            if self.slots is not None and self.slots.free_slots == 0:
                break              # the slot pool is full: a finish frees one
            want_keys = ((self._uses_pages and self.cache.prefix_cache)
                         or self.ckpts is not None)
            if want_keys and seq.prefix_keys is None:
                seq.prefix_keys = self.cache.prefix_keys(seq.prompt)
            if self._uses_pages:
                pages, matched = self.cache.lookup_prefix(seq.prompt,
                                                          seq.prefix_keys)
            else:
                pages, matched = [], 0
            restore = None
            if self.slots is not None:
                # a slot family resumes only where a state checkpoint
                # exists (pages alone cannot rebuild the recurrent state);
                # the hybrid caps it at the page match and drops the
                # unusable page tail
                if self.ckpts is not None:
                    limit = (matched if self._uses_pages
                             else seq.prompt_len - 1)
                    matched, restore = self.ckpts.lookup(seq.prefix_keys,
                                                         limit)
                else:
                    matched = 0
                if self._uses_pages:
                    pages = pages[:matched // self.cache.block_size]
            need_new = self._cross_blocks + (
                max(0, self.cache.blocks_for_tokens(seq.replay_len)
                    - len(pages)) if self._uses_pages else 0)
            avail = (self.cache.free_blocks + self.cache.cached_blocks
                     - sum(1 for p in pages if self.cache.is_cached(p)))
            if self.running and need_new + self.watermark > avail:
                break
            # re-admissions re-attach the sequence's own pages; count only
            # first admissions so the hit rate reports cross-request sharing.
            first = seq.restarts == 0
            self.cache.attach(seq.seq_id, pages,
                              query_tokens=seq.prompt_len if first else 0,
                              hit_tokens=matched if first else 0)
            if self._cross_blocks and self.cache.alloc_cross(
                    seq.seq_id, self.state_spec.cross_tokens) is None:
                self.cache.release(seq.seq_id)
                break
            if self.slots is not None:
                self.slots.acquire(seq.seq_id)
            seq.prefilled = matched
            seq.state_ready = False
            seq._restore = restore
            self.running.append(self.waiting.popleft())
            self.admitted += 1
            n += 1
        return n

    # -- on-demand growth + preemption ----------------------------------------

    def ensure_tokens(self, seq: Sequence, start: int,
                      end: int) -> Optional[List[Tuple[int, int]]]:
        """Make positions ``[start, end)`` writable for ``seq``; on pool
        exhaustion preempt the youngest running sequence and retry.
        Returns the COW page copies, or None if ``seq`` itself was
        preempted. Slot state is fixed-size: its growth is free."""
        if not self._uses_pages:
            return []
        while True:
            copies = self.cache.append_tokens(seq.seq_id, start, end)
            if copies is not None:
                return copies
            victim = self.running[-1]
            self.preempt(victim)
            if victim is seq:
                return None

    def preempt(self, seq: Sequence) -> None:
        """Release page refs and push the sequence to the *front* of the
        waiting queue, outputs intact."""
        self.running.remove(seq)
        self.cache.release(seq.seq_id)
        if self.slots is not None:
            self.slots.release(seq.seq_id)
        seq.prefilled = 0
        seq.state_ready = False
        seq._restore = None
        seq.restarts += 1
        self.waiting.appendleft(seq)
        self.preemptions += 1

    # -- step composition -----------------------------------------------------

    def next_prefill(self) -> Optional[Sequence]:
        """Oldest running sequence that still has replay left to write."""
        for seq in self.running:
            if seq.in_prefill and not seq.done:
                return seq
        return None

    def decode_batch(self, limit: int) -> List[Sequence]:
        """Up to ``limit`` running sequences ready to decode a token."""
        return [s for s in self.running
                if not s.in_prefill and not s.done][:limit]

    def decode_horizon(self, lanes: List[Sequence],
                       max_horizon: int) -> int:
        """Safe number of fused decode tokens before the next scheduling
        event: capped by the smallest remaining budget over the batch,
        and 1 while any running sequence still has prefill to write.
        Eos/stop finishes are data-dependent and handled by
        post-truncation instead."""
        if not lanes:
            return 0
        if any(s.in_prefill for s in self.running):
            return 1
        h = max(1, max_horizon)
        for s in lanes:
            h = min(h, s.max_new_tokens - len(s.out))
        return h

    def spec_ks(self, lanes: List[Sequence], spec) -> List[int]:
        """Per-lane draft lengths for one speculative verify round.

        Each lane runs an EMA acceptance-rate controller
        (:meth:`spec_feedback`): K starts at ``spec.max_k``, halves when
        drafts stop paying and doubles back when they do. At K = 0 the
        lane decodes through the plain horizon; after ``spec.retry_after``
        rounds there it re-probes with K = 1 and a reset EMA. A verify
        emits at most K + 1 tokens, so K is clipped to the remaining
        budget minus one."""
        ks = []
        for s in lanes:
            if s.spec_k is None:
                s.spec_k = spec.max_k
            elif s.spec_k == 0:
                s.spec_cool += 1
                if s.spec_cool >= spec.retry_after:
                    s.spec_k, s.spec_ema, s.spec_cool = 1, 1.0, 0
            ks.append(max(0, min(s.spec_k,
                                 s.max_new_tokens - len(s.out) - 1)))
        return ks

    def spec_feedback(self, seq: Sequence, proposed: int, accepted: int,
                      spec) -> None:
        """Fold one verify round's acceptance into the lane's EMA and
        adapt its K; a round with no proposal carries no signal."""
        if proposed <= 0:
            return
        a = spec.ema_alpha
        seq.spec_ema = (1 - a) * seq.spec_ema + a * (accepted / proposed)
        if seq.spec_ema < spec.demote_below:
            seq.spec_k //= 2
        elif seq.spec_ema > spec.promote_above:
            seq.spec_k = min(max(2 * seq.spec_k, 1), spec.max_k)

    def finish(self, seq: Sequence) -> None:
        """Release page refs and the slot; registered prompt pages stay
        hot."""
        self.running.remove(seq)
        self.cache.release(seq.seq_id)
        if self.slots is not None:
            self.slots.release(seq.seq_id)
        self.finished += 1

    def cancel(self, seq: Sequence) -> bool:
        """Cancellation, a finish event like any other: a running
        sequence is reaped at once (page refs released, its lane free
        for the next step), a waiting one leaves the queue. False if the
        sequence is no longer tracked (already finished)."""
        if seq in self.running:
            self.running.remove(seq)
            self.cache.release(seq.seq_id)
            if self.slots is not None:
                self.slots.release(seq.seq_id)
        else:
            try:
                self.waiting.remove(seq)
            except ValueError:
                return False
        seq.finish_reason = "cancelled"
        self.cancelled += 1
        return True

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.running)
