"""Runtime sanitizers for the serving hot loop (the counterpart of
``repro/analysis/sanitizers.py``, with its names and report keys).

* **Recompile sentinel** — the port has no jit to retrace: what a warmed
  decode loop must not grow is its kernels and its device memory. The
  sentinel watches counters against budgets: the kernel libraries loaded
  (``kernels.build._LIBS``: a new one is an ``nvcc`` build inside the
  loop) and, on the card, the caching allocator's device segments
  (``torch.cuda.memory_stats()["segment.all.allocated"]``: a new one is a
  ``cudaMalloc`` inside the loop). After :meth:`EngineSanitizer.freeze`
  any growth raises.
* **Transfer guard** — after ``freeze()``, each engine step on the card
  runs under ``torch.cuda.set_sync_debug_mode("error")``: any implicit
  device sync (``.item()``, ``.cpu()``, ``nonzero``, a synchronous upload)
  raises. The engine's sanctioned transfers pass: its whole-array
  readbacks (``serve/engine.py`` ``_host``: the decode horizon's and
  verify's tokens, a prefill's first token, the dense engine's tokens)
  and its uploads (``_tensor``), counted as ``sanctioned_syncs``.
* **Refcount sweep** — every ``sweep_every`` steps the paged KV cache's
  ``check_refcounts()`` and the state slot pool's ``check_slots()``
  recount ownership from the tables against the incremental counts.

``REPRO_SANITIZE=1`` turns :func:`sanitize_enabled` on, as in the
reference. Report keys (:meth:`EngineSanitizer.report`):
``decode_compile_count`` kernel libraries loaded; ``transfers_in_decode``
0 by construction (an unsanctioned sync raises out of ``step()``);
``total_compile_count`` the watched counters' sum; ``sanitized_steps``;
``refcount_sweeps``; and the port's own ``segments`` (device segments
allocated, 0 on the CPU) and ``sanctioned_syncs``.
"""
from __future__ import annotations

import contextlib
import os
from typing import Callable, Dict, Optional

import torch

__all__ = [
    "sanitize_enabled", "RecompileError", "RecompileSentinel",
    "default_budgets", "EngineSanitizer", "attach",
]


def sanitize_enabled() -> bool:
    """True when ``REPRO_SANITIZE`` is set to anything but ''/'0'."""
    return os.environ.get("REPRO_SANITIZE", "0") not in ("", "0")


class RecompileError(AssertionError):
    """A watched counter grew past its budget, or at all after freeze."""


class RecompileSentinel:
    """Watches named counters (zero-argument callables returning an int)
    against budgets. ``check()`` raises :class:`RecompileError` when any
    counter exceeds its budget, or grows at all after :meth:`freeze`."""

    def __init__(self, fns: Dict[str, Callable[[], int]],
                 budgets: Dict[str, Optional[int]]):
        for name, fn in fns.items():
            try:
                ok = isinstance(fn(), int)
            except TypeError:
                ok = False
            if not ok:
                raise TypeError(f"counter {name}: not a zero-argument "
                                "callable returning an int")
        self._fns = dict(fns)
        self.budgets = dict(budgets)
        self._frozen: Optional[Dict[str, int]] = None

    def sizes(self) -> Dict[str, int]:
        return {n: fn() for n, fn in self._fns.items()}

    @property
    def frozen(self) -> bool:
        return self._frozen is not None

    def freeze(self) -> Dict[str, int]:
        """Snapshot the counters; any growth past the snapshot is an
        error from now on (the warmed decode regime)."""
        self._frozen = self.sizes()
        return dict(self._frozen)

    def check(self) -> None:
        for name, size in self.sizes().items():
            if self._frozen is not None and size > self._frozen[name]:
                raise RecompileError(
                    f"{name} grew after freeze(): {self._frozen[name]} -> "
                    f"{size}. A warmed-up decode loop must not build a "
                    "kernel library or allocate a device segment.")
            budget = self.budgets.get(name)
            if budget is not None and size > budget:
                raise RecompileError(
                    f"{name} reached {size}, budget {budget}.")


def _libs() -> int:
    from repro_torch.kernels import build
    return len(build._LIBS)


def default_budgets(engine) -> Dict[str, Optional[int]]:
    """Every kernel source at most once; device segments unbudgeted
    before freeze (the pools and the warm-up allocate them)."""
    from repro_torch.kernels import build
    return {"kernel_libs": len(build.NAMES), "segments": None}


def _counters(engine) -> Dict[str, Callable[[], int]]:
    fns = {"kernel_libs": _libs}
    dev = torch.device(getattr(engine, "device", "cpu"))
    if dev.type == "cuda":
        fns["segments"] = lambda: int(torch.cuda.memory_stats(dev).get(
            "segment.all.allocated", 0))
    return fns


class EngineSanitizer:
    """Wraps an engine's ``step`` with the three runtime sanitizers.

    Attaching installs ``engine.step`` (and the sanctioned ``_tensor``
    and ``_host``) as *instance attributes* shadowing the bound methods,
    so every driver — ``generate()``, the async loop, external step loops
    — goes through the sanitized path without engine changes.
    :meth:`detach` restores the originals.

    Lifecycle: steps run unguarded (kernel builds and allocations are
    legitimate) until :meth:`freeze`; after that each step on the card
    runs under the sync guard and asserts zero counter growth. Budget
    checks and the refcount sweep are always on.
    """

    def __init__(self, engine, *, sweep_every: int = 8,
                 budgets: Optional[Dict[str, Optional[int]]] = None,
                 guard: bool = True):
        self.engine = engine
        self.sentinel = RecompileSentinel(
            _counters(engine),
            default_budgets(engine) if budgets is None else budgets)
        self.sweep_every = sweep_every
        self.guard = guard
        self.steps = 0
        self.sweeps = 0
        # stays 0 by construction: an unsanctioned sync under the guard
        # raises out of step() instead of incrementing a counter, so a
        # run that completes certifies zero.
        self.transfers_in_decode = 0
        self.sanctioned_syncs = 0
        self._guarding = False
        self._inner_step = engine.step
        self._inner = {n: getattr(engine, n) for n in ("_tensor", "_host")}
        engine.step = self._step
        for name, fn in self._inner.items():
            setattr(engine, name, self._sanctioned(fn))

    def _sanctioned(self, fn):
        def call(*args, **kw):
            if not self._guarding:
                return fn(*args, **kw)
            self.sanctioned_syncs += 1
            torch.cuda.set_sync_debug_mode(0)
            try:
                return fn(*args, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("error")
        return call

    @contextlib.contextmanager
    def _guard_ctx(self):
        dev = torch.device(getattr(self.engine, "device", "cpu"))
        if not (self.guard and self.sentinel.frozen and dev.type == "cuda"):
            yield
            return
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        self._guarding = True
        try:
            yield
        finally:
            self._guarding = False
            torch.cuda.set_sync_debug_mode(prev)

    def _step(self) -> None:
        with self._guard_ctx():
            self._inner_step()
        self.steps += 1
        self.sentinel.check()
        if self.sweep_every and self.steps % self.sweep_every == 0:
            cache = getattr(self.engine, "cache", None)
            if cache is not None and hasattr(cache, "check_refcounts"):
                cache.check_refcounts()
                self.sweeps += 1
            slots = getattr(self.engine, "slot_pool", None)
            if slots is not None:
                slots.check_slots()

    def freeze(self) -> Dict[str, int]:
        """Enter the guarded zero-growth regime (call after warm-up)."""
        return self.sentinel.freeze()

    def detach(self) -> None:
        """Restore the engine's original ``step``, ``_tensor`` and
        ``_host``."""
        for name in ("step", *self._inner):
            self.engine.__dict__.pop(name, None)

    def report(self) -> Dict[str, int]:
        """Flat metrics for recording / assertions."""
        sizes = self.sentinel.sizes()
        return {
            "decode_compile_count": sizes.get("kernel_libs", 0),
            "transfers_in_decode": self.transfers_in_decode,
            "total_compile_count": sum(sizes.values()),
            "sanitized_steps": self.steps,
            "refcount_sweeps": self.sweeps,
            "segments": sizes.get("segments", 0),
            "sanctioned_syncs": self.sanctioned_syncs,
        }


def attach(engine, **kw) -> EngineSanitizer:
    """Attach an :class:`EngineSanitizer` to ``engine`` and return it."""
    return EngineSanitizer(engine, **kw)
