"""The cost of one step, counted from a run on the meta device: the
counterpart of ``repro/roofline/hlo_cost.py``.

The reference walks the compiled HLO. The port has no compiled graph: it
runs the step once on ``meta`` tensors, which carry shapes and dtypes and
allocate nothing, under :class:`CostCounter` (a ``TorchDispatchMode``)
and counts every aten op the step issues:

* ``flops_by_type`` — the products (``mm``/``bmm``/``addmm``/``baddbmm``/
  convolution, by ``torch.utils.flop_counter``'s formulas, so the count is
  the one ``FlopCounterMode`` gives a real run) by operand type, and each
  hand-written kernel's operations at their type;
* ``bytes`` — device traffic: the inputs plus outputs of every aten op
  that materializes a tensor, views and metadata ops free (the walker's
  "fusion boundaries = materialized buffers", ``hlo_cost.py:8-9``);
  gathers and in-place index updates touch only the rows they move, as the
  walker counts its gathers and scatters;
* each registry op on meta tensors reaches its kernel's wrapper, which
  allocates what the kernel writes and reports the kernel's work through
  :func:`kernel_work`: inputs read once, outputs written once, the
  operations at their type (the same count ``chip_smoke.py`` bounds each
  kernel with);
* ``peak_bytes`` — the most bytes alive at once, from storage lifetimes
  (each storage rounded up to the caching allocator's 512-byte blocks),
  with the tensors handed to :meth:`CostCounter.resident` alive from the
  start: the step's memory, predicted without a card;
* ``coll_bytes`` — 0: one card has no collectives (the field waits for the
  dry run's mesh cells, ``ROADMAP.md`` queue 1 item 9.4).

A Python loop over tokens (rwkv6's WKV) or over attention blocks would
issue millions of ops at 32k tokens. :class:`Trips` runs two trips of it
on meta: the first counted once, the second ``n - 1`` times (the
walker's ``known_trip_count``), their autograd nodes' backward likewise.
Every trip has the same shapes, so the forward's counts are the full
loop's; a backward adds each loop input's gradients from two trips where
the full loop adds ``n``. The bytes the second trip leaves alive (its
kept results, its saved activations, the carry it consumed; not the carry
it hands on) stand for the ``n - 2`` trips not run.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

aten = torch.ops.aten

# operations a kernel does per element it normalizes or softmaxes (the
# counts chip_smoke.py bounds the kernels with): the SOLE norm's divide,
# round, clip, square, shifts, sums and affine; E2Softmax's max, subtract,
# snap, multiply, round, clip, 2^-k, sum and scale; the exact norm's
# forward and backward
QNORM_OPS_PER_ELEMENT = 16
E2_OPS_PER_ELEMENT = 16
EXACT_NORM_OPS_PER_ELEMENT = 8
EXACT_NORM_BWD_OPS_PER_ELEMENT = 14

ALLOC_BLOCK = 512             # the caching allocator's rounding of a block

_TYPE_OF = {torch.bfloat16: "bfloat16", torch.float16: "bfloat16",
            torch.float32: "float32", torch.float64: "float32",
            torch.int8: "int8", torch.uint8: "int8"}

# allocate only: no byte is moved
_EMPTY = {aten.empty.memory_format, aten.empty_strided.default,
          aten.empty_like.default, aten.new_empty.default,
          aten.new_empty_strided.default}
# read only the rows they gather: 2 x output + the indices
_GATHERS = {aten.index.Tensor, aten.index_select.default,
            aten.gather.default, aten.embedding.default}
# write only the rows they update, in place: 2 x values + the indices
_UPDATES = {aten.index_put_.default, aten._index_put_impl_.default,
            aten.scatter_.src, aten.scatter_add_.default,
            aten.index_add_.default, aten.index_copy_.default}
# write their output only
_FILLS = {aten.fill_.Scalar, aten.fill_.Tensor, aten.zero_.default}


def type_of(dtype: torch.dtype) -> str:
    """The peak-rate class of an operand type (``analysis.PEAK_FLOPS``)."""
    return _TYPE_OF.get(dtype, "float32")


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def distinct_bytes(t: torch.Tensor) -> int:
    """Bytes of the distinct elements a strided view reads: a dim of
    stride 0 (a broadcast) adds none."""
    n = t.element_size()
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def paged_attention_work(q_shape, q_bytes: int, kv_bytes: int,
                         spans: Sequence[Tuple[int, int]], *, causal: bool,
                         kv_heads: int, out_bytes: int = 4
                         ) -> Tuple[int, int]:
    """(bytes, operations) paged attention must move / do: q, the live
    keys' K and V rows and the output once, each lane's ``(q_start,
    kv_len)`` once; 4 x head_dim operations per unmasked (query, key) pair
    and head. ``q_shape`` (B, H, C, d); ``spans`` one ``(q_start,
    kv_len)`` per lane."""
    b, h, c, d = q_shape
    pairs = keys = 0
    for q_start, kv_len in spans:
        keys += kv_len
        for r in range(c):
            pairs += min(kv_len, q_start + r + 1) if causal else kv_len
    moved = (b * h * c * d * q_bytes + 2 * keys * kv_heads * d * kv_bytes
             + b * h * c * d * out_bytes + b * 2 * 4)
    return moved, 4 * d * pairs * h


@dataclasses.dataclass
class Cost:
    """One step's counts (per device; one device here)."""
    flops_by_type: Dict[str, float] = dataclasses.field(default_factory=dict)
    product_flops: float = 0.0     # aten products, outside the kernels
    kernel_flops: float = 0.0      # the hand-written kernels' operations
    bytes: float = 0.0
    kernel_bytes: float = 0.0      # the part of ``bytes`` the kernels move
    peak_bytes: float = 0.0
    resident_bytes: float = 0.0    # alive before the step ran
    coll_bytes: float = 0.0
    coll_op_bytes: float = 0.0
    coll_by_kind: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def flops(self) -> float:
        return sum(self.flops_by_type.values())

    def row(self) -> Dict[str, object]:
        return {"flops_by_type": dict(self.flops_by_type),
                "product_flops": self.product_flops,
                "kernel_flops": self.kernel_flops, "bytes": self.bytes,
                "kernel_bytes": self.kernel_bytes,
                "peak_bytes": self.peak_bytes,
                "resident_bytes": self.resident_bytes,
                "coll_bytes": self.coll_bytes}


class CostCounter(TorchDispatchMode):
    """Counts the ops run under it into :attr:`cost`; :attr:`records`
    keeps ``[calls, bytes, flops]`` per (op, output shape) for
    ``roofline.breakdown``. Use as a context manager around one meta run
    of the step."""

    def __init__(self, unroll: bool = False):
        super().__init__()
        self.unroll = unroll     # run every trip of a :class:`Trips` loop
        self.cost = Cost()
        self.records: Dict[Tuple[str, str], List[float]] = \
            collections.defaultdict(lambda: [0, 0.0, 0.0])
        self._sizes: Dict[int, int] = {}
        self._serial: Dict[int, int] = {}
        self._next = 0
        self._live = 0
        self._scale = 1
        self._trip_nodes: List[Tuple[int, int, int]] = []
        self._repeated: Dict[int, weakref.ref] = {}  # a Trips loop's copies

    # -- memory ---------------------------------------------------------------
    def _track(self, t: torch.Tensor, extra: int = 0) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._sizes:
            if extra:
                self._sizes[key] += extra
                self._grow(extra)
            return
        n = -(-st.nbytes() // ALLOC_BLOCK) * ALLOC_BLOCK + extra
        self._sizes[key] = n
        self._serial[key] = self._next
        self._next += 1
        self._grow(n)
        weakref.finalize(st, self._free, key)

    def _grow(self, n: int) -> None:
        self._live += n
        self.cost.peak_bytes = max(self.cost.peak_bytes, self._live)

    def _free(self, key: int) -> None:
        self._live -= self._sizes.pop(key, 0)
        self._serial.pop(key, None)

    def resident(self, tree) -> int:
        """Count the tensors of ``tree`` (nested dicts, lists, tuples) as
        alive from now on, until they die; returns their bytes."""
        before = self._live
        for t in _tensors(tree):
            self._track(t)
        self.cost.resident_bytes += self._live - before
        return self._live - before

    @property
    def live_bytes(self) -> int:
        return self._live

    # -- trips ----------------------------------------------------------------
    def _mult(self) -> int:
        m = self._scale
        if self._trip_nodes:
            node = torch._C._current_autograd_node()
            if node is not None:
                nr = node._sequence_nr()
                for lo, hi, n in self._trip_nodes:
                    if lo <= nr < hi:
                        m *= n
        return m

    @contextlib.contextmanager
    def scaled(self, n: int):
        """Count what runs inside ``n`` times, and the backward of the
        autograd nodes it makes ``n`` times."""
        lo = torch._C._autograd._get_sequence_nr()
        self._scale *= n
        try:
            yield
        finally:
            self._scale //= n
            hi = torch._C._autograd._get_sequence_nr()
            if hi > lo:
                self._trip_nodes.append((lo, hi, n))

    def _alive_since(self, serial: int) -> Dict[int, int]:
        """{storage key: bytes} of the storages alive now that were
        tracked from allocation ``serial`` on."""
        return {k: self._sizes[k] for k, v in self._serial.items()
                if v >= serial}

    # -- counting -------------------------------------------------------------
    def _record(self, name: str, shape: str, moved: float,
                flops: Dict[str, float], kernel: bool) -> None:
        m = self._mult()
        c = self.cost
        c.bytes += moved * m
        total = 0.0
        for kind, f in flops.items():
            c.flops_by_type[kind] = c.flops_by_type.get(kind, 0.0) + f * m
            total += f * m
        if kernel:
            c.kernel_bytes += moved * m
            c.kernel_flops += total
        else:
            c.product_flops += total
        rec = self.records[(name, shape)]
        rec[0] += m
        rec[1] += moved * m
        rec[2] += total

    def kernel(self, name: str, moved: float, ops: Dict[str, float],
               shape=()) -> None:
        """One launch of a hand-written kernel moving ``moved`` bytes and
        doing ``ops`` operations by type."""
        self._record("kernel:" + name, str(tuple(shape)), moved, ops,
                     kernel=True)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _tensors(out)
        ins = _tensors((args, kwargs))
        if all(t.device.type == "cpu" for t in outs + ins):
            return out                         # host work, not the card's
        for t in outs:
            self._track(t)
        moved = self._bytes(func, ins, outs)
        flops = {}
        packet = func.overloadpacket
        if packet in flop_registry:
            f = flop_registry[packet](*args, **kwargs, out_val=out)
            if f:
                flops[type_of(ins[0].dtype)] = float(f)
        if moved or flops:
            shape = str(tuple(outs[0].shape)) if outs else "()"
            self._record(str(packet), shape, moved, flops, kernel=False)
        return out

    def _bytes(self, func, ins: List[torch.Tensor],
               outs: List[torch.Tensor]) -> int:
        repeated = self._repeated
        if func in _EMPTY:
            return 0
        mutable = func._schema.is_mutable
        if not mutable and outs:
            held = {id(t.untyped_storage()) for t in ins}
            if all(id(t.untyped_storage()) in held for t in outs):
                return 0                       # a view or an alias
        if func in _GATHERS:
            return 2 * sum(nbytes(t) for t in outs) + sum(
                nbytes(t) for t in ins[1:] if not t.is_floating_point())
        if func is aten.scatter_.value:        # (self, dim, index, scalar)
            return ins[1].numel() * (2 * ins[0].element_size()
                                     + ins[1].element_size())
        if func in _UPDATES:                   # the values come last
            return 2 * nbytes(ins[-1]) + sum(nbytes(t) for t in ins[1:-1])
        if func in _FILLS or func.name().endswith("_like"):
            return sum(nbytes(t) for t in outs)
        if func is aten.copy_.default:
            return nbytes(ins[0]) + nbytes(ins[1])
        seen, moved = set(), 0
        for t in ins:
            ref = repeated.get(id(t))
            if id(t) not in seen or (ref is not None and ref() is t):
                seen.add(id(t))
                moved += nbytes(t)
        return moved + sum(nbytes(t) for t in outs)


def active() -> Optional[CostCounter]:
    """The innermost :class:`CostCounter` in force, or None."""
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, CostCounter):
            return mode
    return None


def io_bytes(*tensors) -> int:
    """Bytes of ``tensors`` (None skipped), each read or written once."""
    return sum(nbytes(t) for t in tensors if t is not None)


def kernel_work(name: str, moved: float, ops: Dict[str, float],
                shape=()) -> None:
    """What a kernel wrapper's meta branch reports in place of a launch:
    the bytes the kernel moves (its inputs read once, its outputs written
    once) and its operations by type, to the counter in force (none:
    nothing is counted)."""
    counter = active()
    if counter is not None:
        counter.kernel(name, moved, ops, shape)


class Trips:
    """``for t in Trips(n, device)`` is ``for t in range(n)``, except on
    the meta device under a counter (not ``unroll``), where two trips run,
    the second counted ``n - 1`` times (see the module docstring). A loop
    that hands a tensor to its next trip names it with :meth:`carry` each
    trip; one that keeps a result per trip passes its list through
    :meth:`kept` after the loop."""

    def __init__(self, n: int, device):
        self.n = n
        c = active() if torch.device(device).type == "meta" else None
        self.counter = None if (c is None or c.unroll or n <= 2) else c
        self._carries: List[set] = []

    def __iter__(self):
        c = self.counter
        if c is None:
            yield from range(self.n)
            return
        yield 0
        start = c._next
        peak, c.cost.peak_bytes = c.cost.peak_bytes, c._live
        with c.scaled(self.n - 1):
            yield 1
        trip_peak = c.cost.peak_bytes
        c.cost.peak_bytes = max(peak, trip_peak)
        self._trip = (start, trip_peak)
        if torch.is_grad_enabled():
            # the second trip's saved activations, kept results and the
            # carry it took in stand for the n - 2 trips not run (not the
            # carry it hands on)
            alive = c._alive_since(start)
            first, handed = (self._carries + [set(), set()])[:2]
            for key in handed:
                alive.pop(key, None)
            for key in first - handed:
                if key in c._sizes:
                    alive[key] = c._sizes[key]
            self._stand_in(alive)

    def _stand_in(self, alive: Dict[int, int]) -> None:
        """Count each of ``alive``'s storages ``n - 2`` times more while
        it lives, and the peak the last trip would reach over them."""
        c, reps = self.counter, self.n - 2
        for key, size in alive.items():
            c._sizes[key] += reps * size
        grown = reps * sum(alive.values())
        c._live += grown
        c.cost.peak_bytes = max(c.cost.peak_bytes, self._trip[1] + grown)

    def carry(self, *tensors: torch.Tensor) -> None:
        """The tensors this trip hands to the next (the loop's state)."""
        if self.counter is not None:
            self._carries.append({id(t.untyped_storage()) for t in tensors})

    def kept(self, results: List[torch.Tensor]) -> List[torch.Tensor]:
        """The ``n`` results the loop keeps: as given for a loop that ran
        every trip, else the first trip's and the second's ``n - 1``
        times."""
        c = self.counter
        if c is None or len(results) == self.n:
            return results
        if not torch.is_grad_enabled():     # else counted at the loop's end
            self._stand_in({k: c._sizes[k] for k in
                            {id(t.untyped_storage()) for t in results[1:]}
                            if k in c._sizes})
        c._repeated.update((id(t), weakref.ref(t)) for t in results[1:])
        return results[:1] + results[1:] * (self.n - 1)
