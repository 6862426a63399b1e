"""Ref-counted, prefix-cached block-paged KV cache (vLLM-style).

The pool is one device allocation of ``num_blocks`` fixed-size pages per
layer; sequences own host-side *lists of page ids*. Page 0 is the
**null page**: page-table padding, padded prefill tails, idle decode
lanes and null->null copies all write there, so its contents are
arbitrary (finite) garbage at all times and no read path treats it as
signal — attention masks strictly by ``kv_len``, and a null lane's
output feeds only itself.

Pages are shared between sequences through three mechanisms:

* **Ref-counted pages + content-hash index.** Every block-aligned token
  prefix of a finished prefill is chain-hashed and registered (the
  final partial block over exactly the prompt tokens it holds); a later
  prompt walking the same chain attaches the pages (refcount++) and
  prefills only the tail. Each hit is verified against the page's
  ``(parent page, block bytes)`` entry, so a hash collision is a miss.
* **Copy-on-write.** A write into a page with refcount > 1 first copies
  it to a private page; :meth:`append_tokens` returns the (src, dst)
  pairs for the engine to replay on device before the step.
* **LRU eviction.** A registered page whose refcount drops to 0 stays
  resident on an LRU list for future hits and is evicted only under
  allocation pressure.

Encoder-decoder sequences also hold **cross pages** (:meth:`alloc_cross`):
private, never registered, written once by the admission-time encoder
pass, read-only after, freed with the sequence.

Allocation is on demand (:meth:`append_tokens` grows a table to cover
the token range about to be written, or returns None — the preemption
signal). Host state is plain Python; the device pools are torch tensors
that the model steps and :func:`copy_pages` update in place.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


# Logical axes of the page pools: pages replicate (any rank can host any
# sequence's pages); each page's kv_heads dim shards over the model axis.
PAGED_KV_AXES = {
    "k": ("layers", "pages", None, "kv_heads", "head_dim"),
    "v": ("layers", "pages", None, "kv_heads", "head_dim"),
}


class PagedKVCache:
    """Fixed pool of KV pages + host-side tables, refcounts and index."""

    def __init__(self, cfg: ArchConfig, *, num_blocks: int,
                 block_size: int = 16, max_seq_len: int = 512,
                 prefix_cache: bool = True, device="cuda",
                 kv_layers: Optional[int] = None, rules=None):
        """``rules`` (mesh rules, ``sharding.rules``): the pools are
        allocated at one rank's shard of ``PAGED_KV_AXES`` (pages whole,
        each page's kv_heads cut over the model axis where they divide
        it, whole where they do not; replicated over the data axis, which
        is asserted); page tables, refcounts, the prefix index and COW
        are host state, the same on every rank."""
        if num_blocks < 2:
            raise ValueError("need >= 2 blocks (page 0 is the null page)")
        from repro_torch.convert import shard_shape
        from repro_torch.models.layers import kv_store_dtype
        self.cfg = cfg
        self.block_size = block_size
        self.num_blocks = num_blocks
        self.max_blocks_per_seq = cdiv(max_seq_len, block_size)
        self.max_seq_len = max_seq_len
        self.prefix_cache = prefix_cache
        self.device = torch.device(device)
        # kv_layers lets a family page only its attention layers (the
        # hybrid's blocks); a pure-recurrent family passes 0 and gets
        # zero-byte pools with every host-side invariant intact.
        self.kv_layers = cfg.n_layers if kv_layers is None else kv_layers
        shape = (self.kv_layers, num_blocks, block_size, cfg.n_kv_heads,
                 cfg.head_dim)
        if rules is not None:
            spec = rules.spec(PAGED_KV_AXES["k"], shape)
            # every data rank's pool holds every lane's pages: a lane may
            # run on another data rank at its next step
            split = {a for d in spec if d is not None
                     for a in (d if isinstance(d, tuple) else (d,))}
            if split - {"model"}:
                raise ValueError(f"PagedKVCache: pools split over {spec}; "
                                 "they replicate over every axis but model")
            shape = shard_shape(spec, shape, rules)
        dt = kv_store_dtype(cfg)
        self.pools: Dict[str, torch.Tensor] = {
            "k": torch.zeros(shape, dtype=dt, device=self.device),
            "v": torch.zeros(shape, dtype=dt, device=self.device)}
        # LIFO free list; page 0 reserved as the null page.
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))
        # refcount-0 registered pages, LRU order (oldest first).
        self._evictable: "OrderedDict[int, int]" = OrderedDict()
        self._index: Dict[int, int] = {}        # chain hash -> page id
        self._registered: Dict[int, int] = {}   # page id -> chain hash
        # page id -> (parent page id, block token bytes): the content
        # proof every hash hit is verified against.
        self._entries: Dict[int, Tuple[Optional[int], bytes]] = {}
        self._ref: List[int] = [0] * num_blocks
        self._tables: Dict[int, List[int]] = {}
        # encdec: seq id -> its private, read-only cross-attention pages
        self._cross_tables: Dict[int, List[int]] = {}
        self.peak_blocks_in_use = 0
        self.evictions = 0
        self.cow_copies = 0
        self.prefix_hit_tokens = 0
        self.prefix_query_tokens = 0

    # -- accounting -----------------------------------------------------------

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def cached_blocks(self) -> int:
        """Resident refcount-0 pages, reclaimable under pressure."""
        return len(self._evictable)

    @property
    def blocks_in_use(self) -> int:
        """Pages referenced by at least one live sequence."""
        return (self.num_blocks - 1) - len(self._free) - len(self._evictable)

    def free_capacity(self) -> int:
        """Pages an allocation can draw on: free + evictable."""
        return len(self._free) + len(self._evictable)

    def utilization(self) -> float:
        return self.blocks_in_use / max(self.num_blocks - 1, 1)

    def blocks_for_tokens(self, num_tokens: int) -> int:
        return cdiv(num_tokens, self.block_size)

    def is_cached(self, page_id: int) -> bool:
        return page_id in self._evictable

    def prefix_hit_rate(self) -> float:
        return self.prefix_hit_tokens / max(self.prefix_query_tokens, 1)

    def reset_stats(self) -> None:
        """Zero the counters; the peak restarts from the pages in use."""
        self.evictions = 0
        self.cow_copies = 0
        self.prefix_hit_tokens = 0
        self.prefix_query_tokens = 0
        self.peak_blocks_in_use = self.blocks_in_use

    def check_refcounts(self) -> None:
        """Invariant sweep: refcounts match the page tables and are never
        negative; free/evictable/table sets partition the pages."""
        counts = [0] * self.num_blocks
        for table in (*self._tables.values(), *self._cross_tables.values()):
            for pid in table:
                counts[pid] += 1
        assert self._ref == counts, (self._ref, counts)
        assert all(r >= 0 for r in self._ref)
        for pid in self._evictable:
            assert self._ref[pid] == 0 and pid in self._registered
        for pid in self._free:
            assert self._ref[pid] == 0 and pid not in self._registered
        resident = set(self._free) | set(self._evictable)
        for table in self._tables.values():
            assert resident.isdisjoint(table)
        for table in self._cross_tables.values():
            assert resident.isdisjoint(table)
            # cross pages are never registered or shared: refcount 1
            for pid in table:
                assert self._ref[pid] == 1 and pid not in self._registered
        for h, pid in self._index.items():
            assert self._registered.get(pid) == h
            assert pid in self._entries
        assert set(self._entries) == set(self._registered)

    # -- content-hash prefix index --------------------------------------------

    def prefix_keys(self, prompt: np.ndarray) -> List[Tuple[int, bytes]]:
        """(chain hash, block token bytes) per block-aligned prefix, the
        final partial block keyed over exactly the tokens it holds."""
        prompt = np.ascontiguousarray(np.asarray(prompt, np.int32))
        bs = self.block_size
        keys: List[Tuple[int, bytes]] = []
        h: Optional[int] = None
        for i in range(cdiv(len(prompt), bs)):
            seg = prompt[i * bs:min((i + 1) * bs, len(prompt))].tobytes()
            h = hash((h, seg))
            keys.append((h, seg))
        return keys

    def lookup_prefix(self, prompt: np.ndarray,
                      keys: Optional[List[Tuple[int, bytes]]] = None,
                      ) -> Tuple[List[int], int]:
        """Longest verified cached chain for this prompt: (page ids,
        token count), capped at ``len(prompt) - 1`` so the final prompt
        position is always recomputed (its logits seed generation)."""
        plen = len(prompt)
        if not self.prefix_cache or plen <= 1:
            return [], 0
        pages: List[int] = []
        matched = 0
        prev: Optional[int] = None
        for i, (h, seg) in enumerate(keys or self.prefix_keys(prompt)):
            pid = self._index.get(h)
            if pid is None or self._entries.get(pid) != (prev, seg):
                break
            pages.append(pid)
            matched = min((i + 1) * self.block_size, plen)
            prev = pid
        if matched >= plen:
            matched = plen - 1
        if pages and matched <= (len(pages) - 1) * self.block_size:
            # capped below the last page's first slot: it contributes
            # nothing valid, keeping it would only pin it.
            pages.pop()
        return pages, matched

    def attach(self, seq_id: int, pages: Sequence[int], *,
               query_tokens: int = 0, hit_tokens: int = 0) -> None:
        """Create ``seq_id``'s table seeded with cached ``pages``
        (refcount++, pinned out of the evictable list)."""
        if seq_id in self._tables:
            raise ValueError(f"seq {seq_id} already has pages")
        for pid in pages:
            if self._ref[pid] == 0:
                self._evictable.pop(pid)
            self._ref[pid] += 1
        self._tables[seq_id] = list(pages)
        self.prefix_query_tokens += query_tokens
        self.prefix_hit_tokens += hit_tokens
        self.peak_blocks_in_use = max(self.peak_blocks_in_use,
                                      self.blocks_in_use)

    def register_prompt(self, seq_id: int, prompt: np.ndarray,
                        keys: Optional[List[Tuple[int, bytes]]] = None,
                        ) -> None:
        """Index ``seq_id``'s prompt pages by content once the prompt is
        fully written; registration stops at the first level whose
        canonical entry is not byte-identical to this prompt."""
        if not self.prefix_cache:
            return
        table = self._tables[seq_id]
        prev: Optional[int] = None
        for i, (h, seg) in enumerate(keys or self.prefix_keys(prompt)):
            pid = self._index.get(h)
            if pid is not None:
                if self._entries.get(pid) != (prev, seg):
                    break                  # collision: stop indexing deeper
                prev = pid
                continue
            mine = table[i]
            if self._registered.get(mine) is not None:
                break                      # already canonical elsewhere
            self._index[h] = mine
            self._registered[mine] = h
            self._entries[mine] = (prev, seg)
            prev = mine

    # -- allocation -----------------------------------------------------------

    def _acquire(self) -> int:
        """One fresh private page: free list first, else evict the LRU
        cached page (unregistering it from the index)."""
        if self._free:
            pid = self._free.pop()
        else:
            pid, h = self._evictable.popitem(last=False)
            del self._index[h]
            del self._registered[pid]
            del self._entries[pid]
            self.evictions += 1
        self._ref[pid] = 1
        return pid

    def append_tokens(self, seq_id: int, start: int,
                      end: int) -> Optional[List[Tuple[int, int]]]:
        """Make token positions ``[start, end)`` privately writable:
        grow the table to cover ``end`` tokens and copy-on-write every
        shared page the range touches. Returns the (src, dst) page
        copies to replay on device before writing, or None (no state
        change) if the pool cannot cover the growth."""
        table = self._tables[seq_id]
        bs = self.block_size
        need = cdiv(end, bs)
        if need > self.max_blocks_per_seq:
            raise ValueError(
                f"seq {seq_id} would span {need} pages "
                f"(max_blocks_per_seq {self.max_blocks_per_seq})")
        grow = max(0, need - len(table))
        cow = [i for i in range(start // bs, cdiv(end, bs))
               if i < len(table) and self._ref[table[i]] > 1]
        if grow + len(cow) > self.free_capacity():
            return None
        copies: List[Tuple[int, int]] = []
        for i in cow:
            old = table[i]
            new = self._acquire()
            copies.append((old, new))
            self._ref[old] -= 1
            table[i] = new
            self.cow_copies += 1
        for _ in range(grow):
            table.append(self._acquire())
        self.peak_blocks_in_use = max(self.peak_blocks_in_use,
                                      self.blocks_in_use)
        return copies

    def _drop(self, pid: int) -> None:
        """Drop one reference; a page reaching 0 returns to the free list,
        or to the evictable LRU (MRU end) if it is registered."""
        self._ref[pid] -= 1
        assert self._ref[pid] >= 0, f"negative refcount on page {pid}"
        if self._ref[pid] == 0:
            h = self._registered.get(pid)
            if h is not None:
                self._evictable[pid] = h
            else:
                self._free.append(pid)

    def truncate(self, seq_id: int, num_tokens: int) -> int:
        """Shrink ``seq_id``'s table to cover ``num_tokens`` tokens (the
        early-exit reclaim of a horizon's pre-extended tail). Returns
        the number of pages dropped."""
        table = self._tables[seq_id]
        keep = self.blocks_for_tokens(num_tokens)
        dropped = 0
        while len(table) > keep:
            self._drop(table.pop())
            dropped += 1
        return dropped

    def release(self, seq_id: int) -> None:
        """Drop ``seq_id``'s references (finish or preemption), tail
        first, so pool pressure evicts chain suffixes before the
        prefixes they hang off. Cross pages go straight back to the free
        list."""
        for pid in reversed(self._tables.pop(seq_id)):
            self._drop(pid)
        for pid in self._cross_tables.pop(seq_id, []):
            self._drop(pid)
            assert self._ref[pid] == 0, f"shared cross page {pid}"

    # -- encdec cross-attention pages -------------------------------------------

    def alloc_cross(self, seq_id: int, n_tokens: int) -> Optional[List[int]]:
        """Reserve private pages for ``n_tokens`` rows of encoder cross
        K/V, written once by the admission-time encoder pass and read-only
        until :meth:`release`. Returns the page ids, or None (no state
        change) if the pool cannot cover them."""
        if seq_id in self._cross_tables:
            raise ValueError(f"seq {seq_id} already has cross pages")
        need = self.blocks_for_tokens(n_tokens)
        if need > self.free_capacity():
            return None
        pages = [self._acquire() for _ in range(need)]
        self._cross_tables[seq_id] = pages
        self.peak_blocks_in_use = max(self.peak_blocks_in_use,
                                      self.blocks_in_use)
        return pages

    def has_cross(self, seq_id: int) -> bool:
        return seq_id in self._cross_tables

    def cross_row(self, seq_id: int, width: Optional[int] = None
                  ) -> np.ndarray:
        """(width,) int32 cross-page table, null-page padded."""
        blocks = self._cross_tables[seq_id]
        row = np.zeros((width or len(blocks),), np.int32)
        row[:len(blocks)] = blocks
        return row

    def batch_cross(self, seq_ids: Sequence[Optional[int]],
                    width: int) -> np.ndarray:
        """(len(seq_ids), width) int32; None or crossless rows -> null."""
        out = np.zeros((len(seq_ids), width), np.int32)
        for i, sid in enumerate(seq_ids):
            if sid is not None and sid in self._cross_tables:
                out[i] = self.cross_row(sid, width)
        return out

    def table_row(self, seq_id: int) -> np.ndarray:
        """(max_blocks_per_seq,) int32 page table, null-page padded."""
        row = np.zeros((self.max_blocks_per_seq,), np.int32)
        blocks = self._tables[seq_id]
        row[:len(blocks)] = blocks
        return row

    def batch_tables(self, seq_ids: Sequence[Optional[int]]) -> np.ndarray:
        """(len(seq_ids), max_blocks_per_seq) int32; None rows -> null."""
        out = np.zeros((len(seq_ids), self.max_blocks_per_seq), np.int32)
        for i, sid in enumerate(seq_ids):
            if sid is not None:
                out[i] = self.table_row(sid)
        return out


# -- device-side ops (called inside the model steps) --------------------------


def write_tokens(pool: torch.Tensor, kv: torch.Tensor, block_ids: torch.Tensor,
                 offsets: torch.Tensor) -> torch.Tensor:
    """Scatter token KV rows into one layer's page pool, **in place**.

    pool: (N, bs, KV, hd); kv: (B, C, KV, hd); block_ids/offsets: (B, C)
    page id / in-page slot per token (masked tokens aim at page 0).
    """
    pool[block_ids.long(), offsets.long()] = kv.to(pool.dtype)
    return pool


def gather_kv(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """One layer's pages gathered to a contiguous cache: pool (N, bs, KV,
    hd), table (B, NB) -> (B, NB * bs, KV, hd)."""
    bs, kvh, hd = pool.shape[1:]
    b, nb = table.shape
    return pool[table.reshape(-1).long()].reshape(b, nb * bs, kvh, hd)


def slots_for_positions(positions: torch.Tensor, block_size: int,
                        tables: torch.Tensor):
    """Map absolute positions (B, C) + tables (B, NB) -> (block_ids,
    offsets). Out-of-range positions route to the null page 0."""
    nb = tables.shape[1]
    blk_idx = torch.div(positions, block_size, rounding_mode="floor")
    in_range = (blk_idx >= 0) & (blk_idx < nb)
    block_ids = torch.gather(tables.long(), 1,
                             torch.clamp(blk_idx, 0, nb - 1).long())
    block_ids = torch.where(in_range, block_ids, 0)
    offsets = torch.remainder(positions, block_size)
    return block_ids, offsets


def copy_pages(pools: Dict[str, torch.Tensor], src: torch.Tensor,
               dst: torch.Tensor) -> Dict[str, torch.Tensor]:
    """COW on device: duplicate pages ``src`` into ``dst`` across all
    layers of every pool, in place."""
    for pool in pools.values():
        pool[:, dst] = pool[:, src]
    return pools
