"""Per-sequence recurrent state slots and block-boundary checkpoints (the
port's copy of ``repro.serve.state``).

Recurrent layers (rwkv6's WKV state and token-shift rows, the RG-LRU
hidden and causal-conv state) hold **fixed-size** state per sequence,
whatever its length, so paging buys nothing there: a sequence needs one
*slot* of a preallocated pool. :class:`StateSlotPool` is that pool: one
device tensor per state leaf of ``(num_slots,) + slot_shape``, with slot 0
the **null slot** (padded lanes gather and scatter it; its contents are
garbage and no read path treats them as signal). The host side is a LIFO
free list; slots are never shared, copied on write or grown.

A slot is overwritten by every prefill chunk and decode step, so prefix
caching cannot share it as it shares pages. :class:`StateCheckpointCache`
keeps **block-boundary checkpoints** instead: at each block-aligned
prefill boundary inside the prompt the engine copies the sequence's slot
to host memory and registers it under the page cache's chain-hash prefix
keys (``PagedKVCache.prefix_keys``). A later prompt on the same chain
restores the deepest checkpointed boundary into a fresh slot and prefills
only the tail. Every hit is verified against the stored ``(parent hash,
block token bytes)`` pair, so a hash collision is a miss, never foreign
state.

The hybrid holds both pools: its attention blocks page their KV and its
recurrent layers keep a slot, and a prefix hit must cover both (the
scheduler resumes at the deepest checkpoint the page match also covers).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.models.state import tree_map


class StateSlotPool:
    """Fixed pool of per-sequence recurrent-state slots: ``slots`` is the
    device tree (one slot-major tensor per state leaf), ownership a host
    free list. Slot 0 is the null slot."""

    def __init__(self, spec, *, num_slots: int, device="cuda"):
        if num_slots < 2:
            raise ValueError("need >= 2 slots (slot 0 is the null slot)")
        if not spec.has_slots:
            raise ValueError(
                f"family {spec.family!r} declares no slot state")
        self.spec = spec
        self.num_slots = num_slots
        self.slots = tree_map(
            lambda leaf: torch.zeros((num_slots,) + tuple(leaf.shape),
                                     dtype=leaf.dtype, device=device),
            spec.slot_shapes)
        # LIFO free list; slot 0 reserved as the null slot.
        self._free: List[int] = list(range(num_slots - 1, 0, -1))
        self._owner: Dict[int, int] = {}       # seq_id -> slot id
        self.peak_slots_in_use = 0

    # -- accounting -----------------------------------------------------------

    @property
    def free_slots(self) -> int:
        return len(self._free)

    @property
    def slots_in_use(self) -> int:
        return len(self._owner)

    @property
    def bytes_per_slot(self) -> int:
        return self.spec.slot_bytes()

    def reset_stats(self) -> None:
        self.peak_slots_in_use = self.slots_in_use

    def check_slots(self) -> None:
        """Invariant sweep: owned and free slots partition [1, num_slots);
        slot 0 is never owned or free-listed."""
        owned = set(self._owner.values())
        free = set(self._free)
        assert not owned & free, (owned, free)
        assert owned | free == set(range(1, self.num_slots))
        assert 0 not in owned and 0 not in free

    # -- ownership ------------------------------------------------------------

    def acquire(self, seq_id: int) -> Optional[int]:
        """Claim a slot for ``seq_id`` (None if the pool is exhausted). Its
        device contents are its previous owner's: the engine zero-fills or
        restores it before the first step that reads it."""
        if seq_id in self._owner:
            raise ValueError(f"seq {seq_id} already owns a slot")
        if not self._free:
            return None
        slot = self._free.pop()
        self._owner[seq_id] = slot
        self.peak_slots_in_use = max(self.peak_slots_in_use,
                                     self.slots_in_use)
        return slot

    def release(self, seq_id: int) -> None:
        self._free.append(self._owner.pop(seq_id))

    def slot_of(self, seq_id: int) -> int:
        return self._owner[seq_id]

    def batch_slots(self, seq_ids: Sequence[Optional[int]]) -> np.ndarray:
        """(len(seq_ids),) int32 slot ids; None rows -> the null slot."""
        return np.array([0 if sid is None else self._owner[sid]
                         for sid in seq_ids], np.int32)


class StateCheckpointCache:
    """Host-side block-boundary recurrent-state checkpoints.

    Entries are keyed by the page cache's chain-hash prefix keys: level
    ``i`` covers prompt tokens ``[0, (i + 1) * block_size)`` and stores
    ``(parent hash, block token bytes, host state tree)``. Lookup walks the
    chain verifying each level's ``(parent, bytes)`` pair and returns the
    deepest boundary not past ``limit``; registration keeps the first tree
    seen for a level. LRU-bounded at ``max_entries``.
    """

    def __init__(self, *, block_size: int, max_entries: int = 256):
        self.block_size = block_size
        self.max_entries = max_entries
        # chain hash -> (parent hash, block bytes, host state tree)
        self._entries: "OrderedDict[int, Tuple[Optional[int], bytes, object]]" = OrderedDict()
        self.hits = 0
        self.queries = 0
        self.hit_tokens = 0

    def __len__(self) -> int:
        return len(self._entries)

    def register(self, keys: List[Tuple[int, bytes]], boundary_tokens: int,
                 host_tree) -> None:
        """Index the state after ``boundary_tokens`` prompt tokens (block
        aligned; ``keys`` is the prompt's ``prefix_keys``)."""
        bs = self.block_size
        if boundary_tokens <= 0 or boundary_tokens % bs:
            raise ValueError(
                f"checkpoint boundary {boundary_tokens} is not "
                f"block-aligned (block_size {bs})")
        level = boundary_tokens // bs - 1
        h, seg = keys[level]
        if h in self._entries:
            self._entries.move_to_end(h)
            return
        parent = keys[level - 1][0] if level > 0 else None
        self._entries[h] = (parent, seg, host_tree)
        while len(self._entries) > self.max_entries:
            self._entries.popitem(last=False)

    def lookup(self, keys: List[Tuple[int, bytes]],
               limit: int) -> Tuple[int, Optional[object]]:
        """Deepest verified checkpointed boundary ``<= limit``: (boundary
        tokens, host state tree) or (0, None)."""
        self.queries += 1
        best: Tuple[int, Optional[object]] = (0, None)
        prev: Optional[int] = None
        for i, (h, seg) in enumerate(keys):
            boundary = (i + 1) * self.block_size
            if boundary > limit:
                break
            e = self._entries.get(h)
            if e is None or e[0] != prev or e[1] != seg:
                break
            self._entries.move_to_end(h)
            best = (boundary, e[2])
            prev = h
        if best[0]:
            self.hits += 1
            self.hit_tokens += best[0]
        return best

    def stats(self) -> Dict[str, int]:
        return {"entries": len(self._entries), "hits": self.hits,
                "queries": self.queries, "hit_tokens": self.hit_tokens}
