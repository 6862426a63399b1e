"""The MoE family's paged engine on the CPU, beyond the parity trace of
``tests/test_torch_moe_paged.py``:

* the port against itself: the paged engine (drop-free routing) gives
  the dense-slot engine's tokens when the latter's capacity cannot bind
  (``capacity_factor`` 64), as the reference's own multi-family test
  holds (``tests/test_multiarch_serve.py``);
* host-side traces in exact mode on mixtral: a COW fork of a shared
  prefix page and recompute-preemption in a tight pool give the JAX
  engine's tokens and every serving counter both report.
"""
import dataclasses

import jax
import numpy as np
import pytest

from _torch_engine_cases import ENGINE_KW, _configs, jax_params_of
from repro.serve.engine import PagedEngine as JaxEngine
from repro.serve.engine import Request as JaxRequest
from repro_torch.convert import params_from_jax
from repro_torch.serve.engine import Engine, PagedEngine, Request

ARCHS = ("mixtral_8x7b", "dbrx_132b")


@pytest.fixture(scope="module")
def jax_params():
    return jax_params_of(ARCHS)


@pytest.mark.parametrize("name", ARCHS)
def test_paged_matches_dense_oracle(name, jax_params):
    jcfg, tcfg = _configs(name, "exact")
    tcfg = dataclasses.replace(tcfg, capacity_factor=64.0)
    params = params_from_jax(jax.tree.map(np.asarray, jax_params[name]),
                             tcfg, "cpu")
    rng = np.random.default_rng(7)
    reqs = [Request(prompt=rng.integers(0, tcfg.vocab_size, n).astype(
        np.int32), max_new_tokens=8) for n in (5, 11, 16, 9)]
    dense = Engine(tcfg, params, batch_size=4, max_len=32,
                   device="cpu").generate(reqs)
    eng = PagedEngine(tcfg, params, device="cpu", **ENGINE_KW)
    assert eng.generate(reqs) == dense
    eng.cache.check_refcounts()
    assert eng.cache.blocks_in_use == 0


@pytest.mark.parametrize("kw,counter", [
    (dict(), "cow_copies"),
    (dict(num_blocks=8, watermark=0), "preemptions")],
    ids=["cow-fork", "preempt"])
def test_host_side_matches_jax_engine(kw, counter, jax_params):
    """Exact mode, mixtral: two waves of two identical 20-token prompts,
    one sharing their first 16 tokens and two unrelated ones."""
    jcfg, tcfg = _configs("mixtral_8x7b", "exact")
    params = jax_params["mixtral_8x7b"]
    tparams = params_from_jax(jax.tree.map(np.asarray, params), tcfg, "cpu")
    rng = np.random.default_rng(3)
    vocab = tcfg.vocab_size
    shared = rng.integers(0, vocab, 20)
    prompts = [shared, shared,
               np.concatenate([shared[:16], rng.integers(0, vocab, 6)]),
               rng.integers(0, vocab, 16), rng.integers(0, vocab, 16)]
    prompts = [p.astype(np.int32) for p in prompts]
    engine_kw = dict(ENGINE_KW, **kw)
    jeng = JaxEngine(jcfg, params, backend="pallas", **engine_kw)
    teng = PagedEngine(tcfg, tparams, device="cpu", **engine_kw)
    outs = []
    for eng, req in ((jeng, JaxRequest), (teng, Request)):
        outs.append([eng.generate([req(prompt=p, max_new_tokens=8)
                                   for p in prompts]) for _ in range(2)])
    teng.cache.check_refcounts()
    assert outs[0] == outs[1]
    jstats, tstats = jeng.stats(), teng.stats()
    common = set(jstats) & set(tstats)
    assert len(common) >= 20
    assert {k: tstats[k] for k in common} == {k: jstats[k] for k in common}
    assert tstats[counter] > 0
