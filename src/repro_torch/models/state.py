"""Paged *sequence state*: what one sequence's serve-time state is for a
model family (the port's copy of ``repro.models.state``).

* ``kv_layers``   — layers of paged self-attention KV the family writes
  (0: attention-free; the hybrid counts its attention blocks only).
* ``slot_shapes`` — a tree of :class:`SlotLeaf` (torch shape and dtype,
  no batch dim) for the fixed-size recurrent state one sequence owns.
  Slot families get a slot in a :class:`~repro_torch.serve.state.StateSlotPool`
  instead of COW pages, and block-boundary *checkpoints* instead of
  shared prefixes.
* ``cross_tokens`` — read-only cross-attention rows parked at admission
  (encdec; 0 elsewhere).
* capability flags — features are gated, not approximated: speculative
  decoding on a recurrent family raises.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Tuple

import torch


class SlotLeaf(NamedTuple):
    """One leaf of a family's per-sequence slot state."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def sds(shape, dtype) -> SlotLeaf:
    return SlotLeaf(tuple(shape), dtype)


def leaves(tree):
    """The :class:`SlotLeaf` (or tensor) leaves of a nested dict, in key
    order."""
    if isinstance(tree, dict):
        for k in tree:
            yield from leaves(tree[k])
    else:
        yield tree


def tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts of one structure."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


@dataclasses.dataclass(frozen=True)
class SequenceStateSpec:
    """What one sequence's serve-time state is, for one model family.
    ``slot_shapes`` None: no recurrent state. ``window`` mirrors
    ``cfg.window`` so the engine can hold ``max_seq_len`` to it (pages are
    append-only)."""
    family: str
    kv_layers: int = 0
    cross_tokens: int = 0
    slot_shapes: Any = None
    slot_axes: Any = None       # logical axes per slot leaf (no slot dim)
    supports_prefix_cache: bool = False
    supports_spec_decode: bool = False
    supports_cow_fork: bool = False
    window: int = 0
    servable: bool = True

    @property
    def has_pages(self) -> bool:
        return self.kv_layers > 0

    @property
    def has_slots(self) -> bool:
        return self.slot_shapes is not None

    def slot_bytes(self) -> int:
        """Bytes of recurrent state one sequence owns (0 if none)."""
        if self.slot_shapes is None:
            return 0
        return sum(math.prod(leaf.shape) * leaf.dtype.itemsize
                   for leaf in leaves(self.slot_shapes))
