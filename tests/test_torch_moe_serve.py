"""Speculative decoding and the streaming loop on the MoE family, the
port against the JAX package on the CPU (exact mode, the same smoke
weights; ``tests/_torch_serve_helpers.py``):

* the spec engine with the n-gram drafter (a 32-token vocabulary whose
  prompts cover it, so the drafter always proposes) and with an oracle
  drafter (every draft accepted): tokens equal to the JAX spec engine's
  and to the port's plain engine, every ``stats()`` counter both report
  equal; verify runs the (B, C) rows through the drop-free MoE FFN, so
  each row is the decode step's;
* ``AsyncEngine``: open-loop arrivals give the closed batch's tokens and
  the JAX loop's surfacing steps; a cancellation after the first token
  is a finish event that frees the lane's pages.
"""
import numpy as np
import pytest

from _torch_serve_helpers import (OracleDrafter, as_requests, common_stats,
                                  jax_engine, smoke_pair, specs,
                                  torch_engine)
from repro.serve import spec as jspec
from repro.serve.loop import AsyncEngine as JaxAsyncEngine
from repro_torch.serve import spec as tspec
from repro_torch.serve.loop import AsyncEngine

ARCHS = ("mixtral_8x7b", "dbrx_132b")


def _spec_parity(pair, reqs, jdrafter, tdrafter, max_k, plain=None):
    jreqs, treqs = as_requests(reqs)
    jeng = jax_engine(pair, spec_config=jspec.SpecConfig(jdrafter,
                                                         max_k=max_k))
    teng = torch_engine(pair, spec_config=tspec.SpecConfig(tdrafter,
                                                           max_k=max_k))
    jout, tout = jeng.generate(jreqs), teng.generate(treqs)
    teng.cache.check_refcounts()
    if plain is None:
        plain = torch_engine(pair, decode_horizon=8).generate(treqs)
    assert tout == jout
    assert tout == plain
    js, ts = common_stats(jeng.stats(), teng.stats())
    assert ts == js
    assert ts["blocks_in_use"] == 0 and ts["spec_dispatches"] > 0
    return teng.stats()


@pytest.mark.parametrize("arch", ARCHS)
def test_spec_engine_ngram_matches_jax(arch):
    pair = smoke_pair(arch, vocab_size=32)
    rng = np.random.default_rng(44)
    reqs = [dict(prompt=rng.permutation(32).astype(np.int32),
                 max_new_tokens=8) for _ in range(3)]
    _spec_parity(pair, reqs, jspec.NGramDrafter(), tspec.NGramDrafter(), 4)


def test_spec_engine_oracle_matches_jax():
    pair = smoke_pair("mixtral_8x7b")
    reqs = specs(pair.tcfg.vocab_size, 4, np.random.default_rng(42), new=16)
    plain = torch_engine(pair, decode_horizon=8).generate(
        as_requests(reqs)[1])
    drafter = OracleDrafter(dict(enumerate(plain)))
    st = _spec_parity(pair, reqs, drafter, drafter, 8, plain=plain)
    assert st["acceptance_rate"] == 1.0


def _timeline(handles):
    return [(h.tokens, h.finish_reason, h.arrival, h.first_token_step,
             h.finish_step, h.token_steps) for h in handles]


def test_async_engine_matches_jax_and_cancels():
    pair = smoke_pair("dbrx_132b")
    reqs = specs(pair.tcfg.vocab_size, 4, np.random.default_rng(7), plen=12)
    closed = torch_engine(pair, decode_horizon=4).generate(
        as_requests(reqs)[1])
    runs = []
    for loop, rs in zip((JaxAsyncEngine(jax_engine(pair, decode_horizon=4)),
                         AsyncEngine(torch_engine(pair, decode_horizon=4))),
                        as_requests(reqs)):
        handles = [loop.add_request(r, arrival=2 * i)
                   for i, r in enumerate(rs)]
        while handles[1].first_token_step is None:
            loop.step()
        assert handles[1].cancel()
        loop.run()
        loop.engine.cache.check_refcounts()
        assert loop.engine.cache.blocks_in_use == 0
        assert loop.stats()["finish_reasons"] == {"cancelled": 1,
                                                  "length": 3}
        runs.append(handles)
    jh, th = runs
    assert _timeline(th) == _timeline(jh)
    assert [th[i].tokens for i in (0, 2, 3)] == [closed[i] for i in (0, 2, 3)]
    assert 0 < len(th[1].tokens) < 8
