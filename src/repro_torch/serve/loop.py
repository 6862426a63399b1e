"""Streaming engine loop: open-loop arrivals, per-token streaming,
cooperative cancellation and per-request latency accounting on top of
:class:`~repro_torch.serve.engine.PagedEngine`.

``PagedEngine.generate()`` is a closed batch call — submit everything,
step until drained, collect outputs. Real serving is open-loop:
requests arrive over time, stream their tokens as they decode, finish
early on eos/stop, and get cancelled mid-flight. :class:`AsyncEngine`
is that front-end, built around the engine's own step loop (one
``step()`` = admit + one prefill chunk + one decode horizon), so
everything the closed path guarantees — exact-mode token parity,
refcount-clean reclamation, horizon post-truncation — holds under
open-loop traffic too.

The loop is *cooperative*, not thread-based: ``step()`` advances the
virtual clock (engine steps — the same deterministic time base the
Poisson benchmark traces use), admits due arrivals FCFS, runs one
engine iteration, then drains newly decoded tokens to each request's
callback/iterator. Cancellation is applied between engine steps (no
dispatch is ever in flight on the host), and is treated as a finish
event like eos: the scheduler reaps the lane mid-trace and the cache
releases its pages immediately.

Latency is accounted per request in both time bases:

* **steps** — deterministic: arrival step -> first-token step (TTFT)
  and gaps between token surfacings (ITL). The bench-regression guard
  watches the step-based percentiles because they cannot be perturbed
  by runner noise.
* **wall seconds** — what an operator would measure; reported alongside
  but too noisy to gate CI on shared runners. Each drain first
  synchronizes the engine's CUDA device, so a token's surfacing time is
  when it was really on the host.

A token "surfaces" when the host first sees it — a decode horizon of H
tokens surfaces all H at once, so intra-horizon ITL gaps are 0 and the
horizon length shows up in the ITL tail instead. That is the honest
streaming behavior of a horizon-batched engine, not an artifact.
"""
from __future__ import annotations

import time
import zlib
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from repro_torch.serve.engine import PagedEngine, Request
from repro_torch.serve.scheduler import Sequence


def _percentiles(values: List[float]) -> Dict[str, float]:
    if not values:
        return {"p50": 0.0, "p99": 0.0}
    return {"p50": round(float(np.percentile(values, 50)), 4),
            "p99": round(float(np.percentile(values, 99)), 4)}


class RequestHandle:
    """One in-flight request's streaming view.

    ``tokens`` grows as the engine surfaces them; ``finished`` /
    ``finish_reason`` flip when the sequence completes ("eos", "stop",
    "length", "cancelled"). Iterating the handle yields tokens as they
    surface, *driving the loop* while it waits — ``for tok in handle``
    is a complete streaming client.
    """

    def __init__(self, loop: "AsyncEngine", request: Request,
                 arrival: int, on_token: Optional[Callable] = None):
        self.request = request
        self.arrival = arrival           # virtual (engine-step) time
        self.on_token = on_token
        self.tokens: List[int] = []
        self.finish_reason: Optional[str] = None
        self.first_token_step: Optional[int] = None
        self.finish_step: Optional[int] = None
        self.token_steps: List[int] = []     # surfacing step per token
        self.token_walls: List[float] = []   # surfacing wall time
        self.arrival_wall: Optional[float] = None
        self._loop = loop
        self._seq: Optional[Sequence] = None
        self._streamed = 0
        self._order = 0                  # FCFS tiebreak, set at enqueue

    @property
    def finished(self) -> bool:
        return self.finish_reason is not None

    def cancel(self) -> bool:
        """Cooperatively cancel (applied immediately — no dispatch is in
        flight between loop steps). Tokens already surfaced stay; the
        finish reason becomes ``"cancelled"``. No-op on a finished
        request (returns False)."""
        return self._loop.cancel(self)

    def ttft_steps(self) -> Optional[int]:
        if self.first_token_step is None:
            return None
        return self.first_token_step - self.arrival

    def itl_steps(self) -> List[int]:
        """Step gaps between consecutive token surfacings."""
        return [b - a for a, b in zip(self.token_steps, self.token_steps[1:])]

    def __iter__(self) -> Iterator[int]:
        """Stream tokens, running the engine loop as needed."""
        i = 0
        while True:
            while i < len(self.tokens):
                yield self.tokens[i]
                i += 1
            if self.finished:
                return
            self._loop.step()


class AsyncEngine:
    """Open-loop request front-end over ``PagedEngine.step()``.

    ``add_request`` enqueues a request for a (virtual) arrival time —
    the default is "now"; arrivals in the future wait in a time-ordered
    queue and are submitted to the scheduler FCFS once the clock
    reaches them. ``run()`` drives the loop until every request has
    finished (idle gaps in the arrival process fast-forward the clock
    to the next arrival instead of spinning the engine). ``stats()``
    aggregates per-request latency into p50/p99 TTFT and ITL, in engine
    steps (deterministic) and wall milliseconds, next to the wrapped
    engine's own serving counters.
    """

    def __init__(self, engine: PagedEngine):
        self.engine = engine
        self._pending: List[RequestHandle] = []    # sorted by (arrival, #)
        self._arrival_seq = 0
        self._live: Dict[int, RequestHandle] = {}  # seq_id -> handle
        self.completed: List[RequestHandle] = []

    # -- time -----------------------------------------------------------------

    @property
    def now(self) -> int:
        """Virtual clock: the wrapped engine's step counter."""
        return self.engine.steps

    # -- intake ---------------------------------------------------------------

    def add_request(self, request: Request, *, arrival: Optional[int] = None,
                    on_token: Optional[Callable] = None) -> RequestHandle:
        """Enqueue a request for ``arrival`` (engine-step time, default
        now; past times clamp to now). ``on_token(handle, token)`` fires
        for every surfaced token. Validation (can it ever fit?) happens
        at scheduler submission; a never-fits request raises from the
        loop step that tries to submit it — validate eagerly by passing
        ``arrival=None`` and calling :meth:`step` once if needed."""
        h = RequestHandle(self, request,
                          max(self.now, arrival if arrival is not None
                              else self.now), on_token)
        h._order = self._arrival_seq
        self._arrival_seq += 1
        self._pending.append(h)
        self._pending.sort(key=lambda x: (x.arrival, x._order))
        return h

    def cancel(self, handle: RequestHandle) -> bool:
        """Treat cancellation as a finish event: a queued request just
        leaves the queue; a running one is reaped mid-trace (pages
        released, lane free next step)."""
        if handle.finished:
            return False
        if handle._seq is None:
            self._pending.remove(handle)
        elif not self.engine.cancel(handle._seq):
            return False                  # finishing this very step
        else:
            self._live.pop(handle._seq.seq_id, None)
        handle.finish_reason = "cancelled"
        handle.finish_step = self.now
        self.completed.append(handle)
        return True

    # -- the loop -------------------------------------------------------------

    def _admit_due(self) -> None:
        while self._pending and self._pending[0].arrival <= self.now:
            h = self._pending.pop(0)
            h._seq = self.engine.submit(h.request)
            h.arrival_wall = time.perf_counter()
            self._live[h._seq.seq_id] = h

    def _drain(self) -> None:
        """Surface newly decoded tokens and reap finished handles."""
        if self.engine.device.type == "cuda":
            torch.cuda.synchronize(self.engine.device)
        wall = time.perf_counter()
        for sid, h in list(self._live.items()):
            seq = h._seq
            new = seq.out[h._streamed:]
            for tok in new:
                h.tokens.append(tok)
                h.token_steps.append(self.now)
                h.token_walls.append(wall)
                if h.first_token_step is None:
                    h.first_token_step = self.now
                if h.on_token is not None:
                    h.on_token(h, tok)
            h._streamed = len(seq.out)
            if seq.finish_reason is not None and sid not in (
                    s.seq_id for s in self.engine.sched.running):
                if sid in self.engine._finished:
                    del self.engine._finished[sid]   # loop owns outputs
                h.finish_reason = seq.finish_reason
                h.finish_step = self.now
                del self._live[sid]
                self.completed.append(h)

    @property
    def has_work(self) -> bool:
        return bool(self._pending or self.engine.sched.has_work)

    def step(self) -> None:
        """One loop iteration: admit due arrivals, run one engine step
        (or fast-forward an idle clock to the next arrival), surface
        tokens."""
        self._admit_due()
        if self.engine.sched.has_work:
            self.engine.step()
        elif self._pending:
            self.engine.steps = self._pending[0].arrival
            self._admit_due()
            if self.engine.sched.has_work:
                self.engine.step()
        self._drain()

    def run(self) -> List[RequestHandle]:
        """Drive the loop until drained; completed handles in finish
        order."""
        while self.has_work:
            self.step()
        return self.completed

    # -- accounting -----------------------------------------------------------

    @property
    def outstanding(self) -> int:
        """Requests enqueued or in flight (the routing load signal)."""
        return len(self._pending) + len(self._live)

    def stats(self) -> Dict[str, object]:
        """p50/p99 TTFT + ITL (steps and wall ms) over completed
        requests, finish-reason counts, and the wrapped engine's
        counters."""
        done = self.completed
        ttft_steps = [float(h.ttft_steps()) for h in done
                      if h.ttft_steps() is not None]
        itl_steps = [float(g) for h in done for g in h.itl_steps()]
        ttft_ms = [1e3 * (h.token_walls[0] - h.arrival_wall) for h in done
                   if h.token_walls and h.arrival_wall is not None]
        itl_ms = [1e3 * (b - a) for h in done
                  for a, b in zip(h.token_walls, h.token_walls[1:])]
        reasons: Dict[str, int] = {}
        for h in done:
            reasons[h.finish_reason] = reasons.get(h.finish_reason, 0) + 1
        return {
            "requests": len(done) + len(self._live) + len(self._pending),
            "completed": len(done),
            "finish_reasons": reasons,
            "ttft_steps": _percentiles(ttft_steps),
            "itl_steps": _percentiles(itl_steps),
            "ttft_ms": _percentiles(ttft_ms),
            "itl_ms": _percentiles(itl_ms),
            "engine": self.engine.stats(),
        }


class ReplicatedAsyncEngine:
    """Data-parallel serving: N :class:`AsyncEngine` replicas behind one
    ``add_request`` / ``run`` / ``stats`` front door.

    Each replica wraps its own :class:`PagedEngine` (own KV pool, own
    scheduler, own prefix cache) over *shared* params — on one card, one
    parameter tree; the router decides which replica serves a request:

    * **prefix affinity** — prompts with at least one full KV block are
      routed by a deterministic hash of their first block of tokens, so
      requests sharing a system prompt land on the same replica and hit
      its prefix cache instead of re-prefilling N copies;
    * **least-loaded** — shorter prompts (no full block to key on) go
      to the replica with the fewest outstanding requests.

    ``step()`` round-robins one loop iteration over every replica with
    work, so replicas interleave fairly under a cooperative single-host
    clock; on a multi-process deployment each replica would own a
    process and the router alone would remain.
    """

    def __init__(self, engines: List[PagedEngine]):
        if not engines:
            raise ValueError("ReplicatedAsyncEngine needs >= 1 engine")
        self.replicas = [AsyncEngine(e) for e in engines]
        self._block = engines[0].cache.block_size
        self.routed_by_prefix = 0
        self.routed_by_load = 0

    def route(self, request: Request) -> int:
        """Replica index for one request (pure; exposed for tests)."""
        prompt = np.ascontiguousarray(
            np.asarray(request.prompt, np.int32))
        if len(prompt) >= self._block:
            key = zlib.crc32(prompt[:self._block].tobytes())
            return key % len(self.replicas)
        return min(range(len(self.replicas)),
                   key=lambda i: (self.replicas[i].outstanding, i))

    def add_request(self, request: Request, *,
                    arrival: Optional[int] = None,
                    on_token: Optional[Callable] = None) -> RequestHandle:
        i = self.route(request)
        if len(np.asarray(request.prompt)) >= self._block:
            self.routed_by_prefix += 1
        else:
            self.routed_by_load += 1
        return self.replicas[i].add_request(request, arrival=arrival,
                                            on_token=on_token)

    @property
    def has_work(self) -> bool:
        return any(r.has_work for r in self.replicas)

    def step(self) -> None:
        for r in self.replicas:
            if r.has_work:
                r.step()

    def run(self) -> List[RequestHandle]:
        """Drive every replica until drained; completed handles grouped
        by replica, finish order within each."""
        while self.has_work:
            self.step()
        return [h for r in self.replicas for h in r.completed]

    def stats(self) -> Dict[str, object]:
        """Aggregate counters next to each replica's full stats()."""
        per = [r.stats() for r in self.replicas]
        return {
            "replicas": len(self.replicas),
            "completed": sum(s["completed"] for s in per),
            "decode_tokens": sum(s["engine"]["decode_tokens"]
                                 for s in per),
            "steps": max(s["engine"]["steps"] for s in per),
            "routed_by_prefix": self.routed_by_prefix,
            "routed_by_load": self.routed_by_load,
            "per_replica": per,
        }
