"""The port's recurrent-state serve machinery (``repro_torch.serve.state``,
``repro_torch.models.state``) against the JAX package's on the same
inputs: the slot pool's free list, ownership and invariants, and the
block-boundary checkpoint cache's registration, verified lookup, hash
collisions and LRU eviction on the page cache's chain-hash keys
(``PagedKVCache.prefix_keys`` of both packages, held equal here).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_config
from repro.models import api as japi
from repro.serve.kv_cache import PagedKVCache as JaxCache
from repro.serve.state import StateCheckpointCache as JaxCkpts
from repro.serve.state import StateSlotPool as JaxPool
from repro_torch.configs.base import get_config
from repro_torch.models import api
from repro_torch.models.state import SequenceStateSpec, leaves, sds
from repro_torch.serve.kv_cache import PagedKVCache
from repro_torch.serve.state import StateCheckpointCache, StateSlotPool

ARCHS = ("rwkv6_7b", "recurrentgemma_9b", "qwen2_0_5b")
HYBRID = dict(n_layers=4, n_tail_layers=1)


def _specs(name):
    over = HYBRID if name == "recurrentgemma_9b" else {}
    jcfg = dataclasses.replace(jax_config(name).smoke(), **over)
    tcfg = dataclasses.replace(get_config(name).smoke(), **over)
    return japi.sequence_state_spec(jcfg), api.sequence_state_spec(tcfg)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("name", ARCHS)
def test_state_spec_matches_reference(name):
    """Every field of the family's spec, the slot leaves' shapes and
    dtypes, the axes and ``slot_bytes``."""
    jspec, tspec = _specs(name)
    for f in dataclasses.fields(tspec):
        if f.name not in ("slot_shapes", "slot_axes"):
            assert getattr(tspec, f.name) == getattr(jspec, f.name), f.name
    assert (tspec.has_pages, tspec.has_slots) == (jspec.has_pages,
                                                   jspec.has_slots)
    assert tspec.slot_bytes() == jspec.slot_bytes()
    if jspec.slot_shapes is None:
        assert tspec.slot_shapes is None
        return
    jflat = {k: (tuple(v.shape), str(v.dtype))
             for k, v in _flat(jspec.slot_shapes).items()}
    tflat = {k: (v.shape, str(v.dtype).replace("torch.", ""))
             for k, v in _flat(tspec.slot_shapes).items()}
    assert tflat == jflat
    axes = {k: tuple(v) for k, v in _flat(
        jspec.slot_axes if isinstance(jspec.slot_axes, dict) else {}).items()}
    assert {k: tuple(v) for k, v in _flat(tspec.slot_axes).items()} == axes


def test_slot_bytes_counts_every_leaf():
    spec = SequenceStateSpec(family="x", slot_shapes={
        "a": sds((2, 3), torch.float32), "b": {"c": sds((4,), torch.int8)}})
    assert spec.slot_bytes() == 2 * 3 * 4 + 4
    assert [leaf.shape for leaf in leaves(spec.slot_shapes)] == [(2, 3), (4,)]
    assert SequenceStateSpec(family="dense").slot_bytes() == 0


@pytest.mark.parametrize("name", ("rwkv6_7b", "recurrentgemma_9b"))
def test_slot_pool_follows_reference(name):
    """The same acquire/release sequence on both pools hands out the same
    slot ids (LIFO, slot 0 never), the same exhaustion and peaks; the
    device tree has one (num_slots,) + shape zero tensor per leaf."""
    jspec, tspec = _specs(name)
    jp, tp = JaxPool(jspec, num_slots=4), StateSlotPool(tspec, num_slots=4,
                                                        device="cpu")
    for leaf_spec, leaf in zip(leaves(tspec.slot_shapes), leaves(tp.slots)):
        assert tuple(leaf.shape) == (4,) + leaf_spec.shape
        assert leaf.dtype == leaf_spec.dtype and not leaf.any()
    ops = [("acq", 10), ("acq", 11), ("rel", 10), ("acq", 12), ("acq", 13),
           ("acq", 14), ("rel", 11), ("acq", 15), ("rel", 13)]
    for op, sid in ops:
        if op == "acq":
            assert tp.acquire(sid) == jp.acquire(sid)
        else:
            tp.release(sid)
            jp.release(sid)
        tp.check_slots()
        assert (tp.free_slots, tp.slots_in_use, tp.peak_slots_in_use) == (
            jp.free_slots, jp.slots_in_use, jp.peak_slots_in_use)
    assert list(tp.batch_slots([12, None, 15])) == list(
        jp.batch_slots([12, None, 15]))
    assert tp.bytes_per_slot == jp.bytes_per_slot
    tp.reset_stats()
    assert tp.peak_slots_in_use == tp.slots_in_use == 2


def test_slot_pool_errors():
    _, tspec = _specs("rwkv6_7b")
    with pytest.raises(ValueError, match="null slot"):
        StateSlotPool(tspec, num_slots=1, device="cpu")
    with pytest.raises(ValueError, match="declares no slot state"):
        StateSlotPool(_specs("qwen2_0_5b")[1], num_slots=4, device="cpu")
    pool = StateSlotPool(tspec, num_slots=2, device="cpu")
    assert pool.acquire(1) == 1
    assert pool.acquire(2) is None
    with pytest.raises(ValueError, match="already owns"):
        pool.acquire(1)


def _keys(block_size, prompt):
    """The chain keys of both packages' page caches for one prompt (held
    equal)."""
    cfg = get_config("rwkv6_7b").smoke()
    tk = PagedKVCache(cfg, num_blocks=4, block_size=block_size,
                      device="cpu", kv_layers=0).prefix_keys(prompt)
    jk = JaxCache(jax_config("rwkv6_7b").smoke(), num_blocks=4,
                  block_size=block_size, kv_layers=0).prefix_keys(prompt)
    assert tk == jk
    return tk


def _tree(i):
    return {"s": torch.full((2,), float(i))}


def test_checkpoints_follow_reference():
    """Registration (block-aligned only, the first tree kept per level),
    the deepest verified boundary under a limit, a break in the chain, a
    collision on a level's hash (the wrong parent or bytes: a miss) and
    LRU eviction at ``max_entries``, with the same hits and stats as the
    reference."""
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, 512, 20).astype(np.int32)
    other = prompt.copy()
    other[9] += 1                          # differs in the third block
    keys, okeys = _keys(4, prompt), _keys(4, other)
    t, j = (StateCheckpointCache(block_size=4, max_entries=3),
            JaxCkpts(block_size=4, max_entries=3))
    for cache in (t, j):
        with pytest.raises(ValueError, match="block-aligned"):
            cache.register(keys, 6, _tree(0))
        for b in (4, 8, 12):
            cache.register(keys, b, _tree(b))
        cache.register(keys, 8, _tree(99))         # the first tree stays
    for limit in (3, 4, 11, 12, 19):
        got, want = t.lookup(keys, limit), j.lookup(keys, limit)
        assert got[0] == want[0]
        if got[0]:
            assert torch.equal(got[1]["s"], _tree(got[0])["s"])
    # a prompt sharing the first two blocks hits at 8, never past them
    assert t.lookup(okeys, 19)[0] == j.lookup(okeys, 19)[0] == 8
    # a forged level-1 entry under the right hash with foreign bytes: miss
    for cache in (t, j):
        h, _ = keys[1]
        parent, _, tree = cache._entries[h]
        cache._entries[h] = (parent, b"forged", tree)
    assert t.lookup(keys, 19)[0] == j.lookup(keys, 19)[0] == 4
    # LRU: a fourth level evicts the least recently used entry
    for cache in (t, j):
        cache.register(keys, 16, _tree(16))
    assert len(t) == len(j) == 3
    assert set(t._entries) == set(j._entries)
    assert t.stats() == j.stats()


def test_checkpoint_lookup_needs_every_level():
    """Lookup walks the chain from level 0 and stops at the first level
    with no checkpoint, as the reference's does: a checkpoint registered
    only at a deeper boundary (prefill chunks longer than a block) is
    never reached."""
    rng = np.random.default_rng(1)
    keys = _keys(4, rng.integers(0, 512, 20).astype(np.int32))
    t, j = StateCheckpointCache(block_size=4), JaxCkpts(block_size=4)
    for cache in (t, j):
        cache.register(keys, 8, _tree(8))
    assert t.lookup(keys, 19) == (0, None)
    assert j.lookup(keys, 19) == (0, None)
    assert t.stats() == j.stats() == {"entries": 1, "hits": 0, "queries": 1,
                                      "hit_tokens": 0}


def test_zero_kv_layers_cache_has_empty_pools():
    cfg = get_config("rwkv6_7b").smoke()
    c = PagedKVCache(cfg, num_blocks=8, block_size=4, device="cpu",
                     kv_layers=0)
    assert c.kv_layers == 0 and all(p.numel() == 0 for p in c.pools.values())
    j = JaxCache(jax_config("rwkv6_7b").smoke(), num_blocks=8, block_size=4,
                 kv_layers=0)
    assert [tuple(p.shape) for p in c.pools.values()] == [
        tuple(p.shape) for p in j.pools.values()]
    assert jnp.size(j.pools["k"]) == 0
