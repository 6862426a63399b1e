"""Finish events in the port on the CPU against the JAX package: the
traces of the reference's ``tests/test_stop_semantics.py`` (eos ids and
multi-token ``stop`` sequences across decode horizons, the device eos
mask against host truncation, COW-forked prefixes that stop apart, the
dense engine's finished-lane masking) through the port's engines and the
JAX ones on the same smoke weights, exact mode.

Each trace gives the JAX engine's tokens, finish reasons and every
``stats()`` counter both engines report. ``test_horizon_tail_pages_
reclaimed`` is left out: its trace fails its own precondition in the
reference (7 distinct greedy tokens where it needs 8).
"""
import numpy as np
import pytest
import torch

from _torch_serve_helpers import (as_requests, common_stats, jax_engine,
                                  smoke_pair, specs, torch_engine)
from repro.serve.engine import Engine as JaxDenseEngine
from repro.serve.sampling import eos_hits as jax_eos_hits
from repro_torch.serve.engine import Engine
from repro_torch.serve.kv_cache import PagedKVCache, slots_for_positions
from repro_torch.serve.sampling import (Sampler, apply_finish, eos_hits,
                                        eos_table)


@pytest.fixture(scope="module")
def exact_lm():
    return smoke_pair()


@pytest.fixture(scope="module")
def solo_oracle(exact_lm):
    """(request spec, eos-free greedy continuation): seed 1's 8 tokens are
    pairwise distinct, so eos and stop placement is positional."""
    spec = specs(exact_lm.tcfg.vocab_size, 1, np.random.default_rng(1),
                 plen=12)[0]
    out = torch_engine(exact_lm, decode_horizon=8).generate(
        as_requests([spec])[1])[0]
    assert len(set(out)) == len(out)
    return spec, out


def _truncated(base, eos_ids):
    for i, t in enumerate(base):
        if t in eos_ids:
            return base[:i + 1]
    return list(base)


def _both(pair, req_specs, **kw):
    """The specs through the JAX and the port paged engines: the port's
    outputs, after checking them, the finish reasons and every common
    counter against JAX's, and the port's stats."""
    jreqs, treqs = as_requests(req_specs)
    jeng, teng = jax_engine(pair, **kw), torch_engine(pair, **kw)
    jout, tout = jeng.generate(jreqs), teng.generate(treqs)
    teng.cache.check_refcounts()
    assert tout == jout
    js, ts = common_stats(jeng.stats(), teng.stats())
    assert ts == js
    assert ts["blocks_in_use"] == 0
    return tout, teng.stats()


@pytest.mark.parametrize("h", [1, 4, 8])
def test_eos_mid_horizon_parity(exact_lm, solo_oracle, h):
    spec, base = solo_oracle
    eos = int(base[2])
    out, st = _both(exact_lm, [dict(spec, eos_ids=(eos,))], decode_horizon=h)
    assert out == [_truncated(base, {eos})]
    assert st["finish_reasons"] == {"eos": 1}
    if h == 8:
        assert st["truncated_tokens"] > 0


def test_eos_on_last_token_of_horizon(exact_lm, solo_oracle):
    spec, base = solo_oracle
    eos = int(base[4])
    assert eos not in base[:4]
    out, st = _both(exact_lm, [dict(spec, eos_ids=(eos,))], decode_horizon=8)
    assert out == [base[:5]]
    assert st["finish_reasons"] == {"eos": 1}
    assert st["truncated_tokens"] == 0


def test_first_token_eos_never_decodes(exact_lm, solo_oracle):
    spec, base = solo_oracle
    out, st = _both(exact_lm, [dict(spec, eos_ids=(int(base[0]),))],
                    decode_horizon=8)
    assert out == [[base[0]]]
    assert st["decode_dispatches"] == 0
    assert st["finish_reasons"] == {"eos": 1}


def test_eos_parity_with_stochastic_sampling(exact_lm):
    pair = exact_lm
    spec = specs(pair.tcfg.vocab_size, 1, np.random.default_rng(11),
                 plen=12, new=10, temperature=0.9, top_k=8, seed=3)[0]
    base, _ = _both(pair, [spec], decode_horizon=8)
    eos = int(base[0][3])
    want = _truncated(base[0], {eos})
    assert len(want) < len(base[0])
    for h in (1, 8):
        out, _ = _both(pair, [dict(spec, eos_ids=(eos,))], decode_horizon=h)
        assert out == [want]


@pytest.mark.parametrize("h", [1, 2, 8])
def test_stop_sequence_spans_horizon_boundary(exact_lm, solo_oracle, h):
    spec, base = solo_oracle
    stop = (int(base[3]), int(base[4]))
    assert stop not in [tuple(base[i:i + 2]) for i in range(3)]
    out, st = _both(exact_lm, [dict(spec, stop=(stop,))], decode_horizon=h)
    assert out == [base[:5]]
    assert st["finish_reasons"] == {"stop": 1}


@pytest.mark.parametrize("stop,eos,new,want", [
    (((5, 6), (3,)), (), [3, 5, 6, 9], ([1, 2, 3], 1, "stop")),
    (((2, 4),), (4,), [4, 7], ([2, 4], 1, "eos")),
    (((1,),), (9,), [1, 9], ([1], 1, "stop"))])
def test_earliest_stop_match_wins(stop, eos, new, want):
    """The cut at the earliest completed stop, eos winning a tie on the
    same token; the same cuts as the reference's ``apply_finish``."""
    from repro.serve.sampling import Sampler as JaxSampler
    from repro.serve.sampling import apply_finish as jax_apply_finish
    prev = {((5, 6), (3,)): [1, 2], ((2, 4),): [2], ((1,),): []}[stop]
    got_out, jax_out = list(prev), list(prev)
    got = apply_finish(Sampler(eos_ids=eos, stop=stop), got_out, new)
    ref = jax_apply_finish(JaxSampler(eos_ids=eos, stop=stop), jax_out, new)
    assert (got_out, *got) == (jax_out, *ref) == want


def test_cow_forked_prefix_stops_differently(exact_lm):
    """Two requests on a cached prompt fork its pages and stop at their
    own eos; run as two waves on one engine of each side."""
    pair = exact_lm
    shared = np.random.default_rng(33).integers(
        0, pair.tcfg.vocab_size, 20).astype(np.int32)
    base_specs = [dict(prompt=shared, max_new_tokens=6)] * 2
    jeng, teng = jax_engine(pair, decode_horizon=8), torch_engine(
        pair, decode_horizon=8)
    outs = []
    for eng, reqs in zip((jeng, teng), as_requests(base_specs)):
        outs.append(eng.generate(reqs))
    assert outs[1] == outs[0] and outs[1][0] == outs[1][1]
    base = outs[1][0]
    eos_a, eos_b = int(base[1]), int(base[4])
    forked = [dict(prompt=shared, max_new_tokens=6, eos_ids=(eos_a,)),
              dict(prompt=shared, max_new_tokens=6, eos_ids=(eos_b,))]
    got = [eng.generate(reqs)
           for eng, reqs in zip((jeng, teng), as_requests(forked))]
    assert got[1] == got[0]
    assert got[1] == [_truncated(base, {eos_a}), _truncated(base, {eos_b})]
    js, ts = common_stats(jeng.stats(), teng.stats())
    assert ts == js
    assert ts["cow_copies"] > 0 and ts["prefix_hit_rate"] > 0
    teng.cache.check_refcounts()
    assert teng.cache.blocks_in_use == 0


def test_host_device_eos_agreement():
    """``eos_hits`` on torch tensors, on numpy and the reference's jitted
    one agree with the host ``Sampler`` through the padded eos table."""
    rng = np.random.default_rng(0)
    samplers = [Sampler(eos_ids=ids) for ids in
                ((), (3,), (7, 11), (0, 5, 9))]
    table = eos_table(samplers)
    assert table.shape == (4, 3)
    toks = rng.integers(0, 16, size=(4, 64)).astype(np.int32)
    host = np.array([[s.is_eos(t) for t in row]
                     for s, row in zip(samplers, toks)])
    cols = range(toks.shape[1])
    np_mask = np.stack([eos_hits(toks[:, j], table) for j in cols], 1)
    dev = np.stack([eos_hits(torch.from_numpy(toks[:, j]),
                             torch.from_numpy(table)).numpy()
                    for j in cols], 1)
    ref = np.stack([np.asarray(jax_eos_hits(toks[:, j], table))
                    for j in cols], 1)
    assert (np_mask == host).all() and (dev == host).all()
    assert (ref == host).all()
    assert not eos_hits(np.arange(16, dtype=np.int32),
                        np.full((16, 2), -1, np.int32)).any()


def test_device_done_mask_matches_host_truncation(exact_lm, solo_oracle):
    """The paged engine's device eos mask against the dense engine's host
    truncation, on both sides."""
    pair = exact_lm
    spec, base = solo_oracle
    ereq = dict(spec, eos_ids=(int(base[3]),))
    paged, _ = _both(pair, [ereq], decode_horizon=8)
    jreq, treq = as_requests([ereq])
    dense = Engine(pair.tcfg, pair.tparams, batch_size=1, max_len=32,
                   device="cpu").generate(treq)
    jdense = JaxDenseEngine(pair.jcfg, pair.jparams, batch_size=1,
                            max_len=32).generate(jreq)
    assert paged == dense == jdense == [_truncated(base, {int(base[3])})]


def test_dense_masks_finished_lanes_mixed_batch(exact_lm):
    pair = exact_lm
    rng = np.random.default_rng(7)
    probe = specs(pair.tcfg.vocab_size, 1, rng, plen=12)[0]
    base = Engine(pair.tcfg, pair.tparams, batch_size=1, max_len=32,
                  device="cpu").generate(as_requests([probe])[1])[0]
    mixed = [dict(probe, max_new_tokens=3),
             dict(probe, eos_ids=(int(base[4]),))]
    mixed += specs(pair.tcfg.vocab_size, 1, rng, plen=12)
    mixed += specs(pair.tcfg.vocab_size, 1, rng, plen=12, new=1)
    jreqs, treqs = as_requests(mixed)
    eng = Engine(pair.tcfg, pair.tparams, batch_size=4, max_len=32,
                 device="cpu")
    jeng = JaxDenseEngine(pair.jcfg, pair.jparams, batch_size=4, max_len=32)
    batched = eng.generate(treqs)
    assert batched == jeng.generate(jreqs)
    assert eng.finish_reasons == jeng.finish_reasons == [
        "length", "eos", "length", "length"]
    alone = [Engine(pair.tcfg, pair.tparams, batch_size=1, max_len=32,
                    device="cpu").generate([r])[0] for r in treqs]
    assert batched == alone
    assert batched[0] == base[:3]
    assert batched[1] == _truncated(base, {int(base[4])})


def test_dense_all_finished_early_exit(exact_lm):
    """Every lane stops at its eos on the first decode call: the loop
    exits there instead of running the budget (counted in decode
    calls)."""
    pair = exact_lm
    probe = specs(pair.tcfg.vocab_size, 1, np.random.default_rng(9),
                  plen=12, new=24)[0]
    base = Engine(pair.tcfg, pair.tparams, batch_size=1, max_len=48,
                  device="cpu").generate(
        as_requests([dict(probe, max_new_tokens=4)])[1])[0]
    eos = dict(probe, eos_ids=(int(base[1]),))
    jreqs, treqs = as_requests([eos, eos])
    eng = Engine(pair.tcfg, pair.tparams, batch_size=2, max_len=48,
                 device="cpu")
    outs = eng.generate(treqs)
    assert outs == JaxDenseEngine(pair.jcfg, pair.jparams, batch_size=2,
                                  max_len=48).generate(jreqs)
    assert all(o == base[:2] for o in outs)
    assert eng.finish_reasons == ["eos", "eos"]
    assert eng.decode_calls == 1
    assert len(eng.generate(as_requests([probe])[1])[0]) == 24


def test_truncate_refcount_correct_under_sharing(exact_lm):
    cfg = exact_lm.tcfg
    cache = PagedKVCache(cfg, num_blocks=12, block_size=4, max_seq_len=40,
                         device="cpu")
    prompt = np.arange(8, dtype=np.int32)
    cache.attach(0, [])
    assert cache.append_tokens(0, 0, 8) == []
    cache.register_prompt(0, prompt)
    pages = list(cache._tables[0])
    cache.attach(1, pages)
    assert cache.append_tokens(1, 8, 20) == []
    cache.check_refcounts()
    free_before = cache.free_blocks
    assert cache.truncate(1, 10) == 2
    cache.check_refcounts()
    assert cache.free_blocks == free_before + 2
    assert [cache._ref[p] for p in pages] == [2, 2]
    assert cache.truncate(1, 0) == 3
    cache.check_refcounts()
    assert [cache._ref[p] for p in pages] == [1, 1]
    cache.release(0)
    cache.check_refcounts()
    assert cache.cached_blocks == 2
    cache.release(1)
    cache.check_refcounts()
    assert cache.blocks_in_use == 0


def test_slots_for_positions_routes_over_range_to_null_page():
    tables = torch.tensor([[3, 7]], dtype=torch.int32)
    positions = torch.tensor([[0, 5, 7, 8, 11, -1]], dtype=torch.int32)
    block_ids, offsets = slots_for_positions(positions, 4, tables)
    assert block_ids.tolist() == [[3, 7, 7, 0, 0, 0]]
    assert offsets.tolist()[0][:4] == [0, 1, 3, 0]
    null_ids, _ = slots_for_positions(positions, 4,
                                      torch.zeros((1, 2), dtype=torch.int32))
    assert null_ids.tolist() == [[0] * 6]
