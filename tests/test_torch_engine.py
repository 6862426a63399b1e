"""The port's PagedEngine on the CPU against the JAX PagedEngine with its
Pallas kernels (interpret mode), on qwen2 and stablelm smoke configs with
the same weights (converted through numpy by ``params_from_jax``).

Each trace runs two waves through both engines: five greedy prompts
(one longer than two prefill chunks, two sharing a 16-token prefix,
8 new tokens, decode horizon 4), then a repeat of a wave-1 prompt (a
prefix hit) with an eos id taken from the JAX engine's own output for
it (an eos finish) and a new prompt on the shared prefix. The configs:
qwen2 and stablelm, minitron and nemotron (squared ReLU, LayerNorm), and
minitron at head dim 128 (``d^-1/2`` no power of two), one file each so
the tier-1 workers share them: this file holds qwen2 (with the host-side
traces and the weight round trip), ``test_torch_engine_stablelm.py``,
``_minitron.py``, ``_nemotron.py`` and ``_hd128.py`` the others; the
trace itself lives in ``tests/_torch_engine_cases.py``.
``check_refcounts`` runs after each wave.

* exact mode: greedy tokens equal; on the host-side traces (COW fork,
  recompute-preemption, LRU eviction) every serving counter is equal too.
* SOLE mode: every ``prefill_paged``/``decode_step_paged`` call the port
  made is replayed through the JAX model on the same inputs and pools.
  Logits agree to 1e-4 absolute where no code flips (fp32 sums in
  another order, XLA's inexact ``exp2`` of integers). A code can flip:
  on the qwen2 trace, in the decode call with one live lane at position
  7 beside three null lanes, the residual stream after layer 0 differs
  by one float32 ulp (1.9e-8), which moves one PTF code of layer 1's
  ln1 norm across its rounding boundary (its output moves by 2.9e-3)
  and the logits by 1.1e-2. So at least 95% of the calls agree to 1e-4,
  and the greedy tokens are equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_engine_cases import (ENGINE_KW, _configs, engine_case,
                                 jax_params_of)
from repro.serve.engine import PagedEngine as JaxEngine
from repro.serve.engine import Request as JaxRequest
from repro_torch.configs.base import get_config
from repro_torch.convert import params_from_jax
from repro_torch.serve.engine import PagedEngine, Request


@pytest.fixture(scope="module")
def jax_params():
    return jax_params_of(("qwen2_0_5b", "stablelm_1_6b"))


@pytest.mark.parametrize("mode", ["exact", "sole"])
@pytest.mark.parametrize("name", ["qwen2_0_5b"])
def test_engine_matches_jax_engine(name, mode, jax_params, monkeypatch):
    engine_case(name, mode, jax_params, monkeypatch)


@pytest.mark.parametrize("kw,counter", [
    (dict(), "cow_copies"),
    (dict(num_blocks=8, watermark=0), "preemptions"),
    (dict(num_blocks=9, max_running=2, decode_batch=2), "evictions")],
    ids=["cow-fork", "preempt", "evict"])
def test_host_side_matches_jax_engine(kw, counter, jax_params):
    """Exact mode, two waves of the same requests (two identical 20-token
    prompts, one sharing their first 16 tokens, two unrelated): in a roomy
    pool the warm wave forks the identical prompts' boundary page (COW); a
    tight pool forces recompute-preemption or LRU eviction. Tokens and
    every serving counter both engines report are equal."""
    jcfg, tcfg = _configs("qwen2_0_5b", "exact")
    params = jax_params["qwen2_0_5b"]
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_jax_round_trip(dtype, jax_params):
    """Projections/embeddings land in cfg.dtype bit-identical to the
    reference's per-use cast; norm leaves stay float32 and exact."""
    params = jax_params["stablelm_1_6b"]
    cfg = dataclasses.replace(get_config("stablelm_1_6b").smoke(),
                              dtype=dtype)
    tp = params_from_jax(jax.tree.map(np.asarray, params), cfg, "cpu")
    jflat = jax.tree_util.tree_flatten_with_path(params)[0]
    assert len(jflat) == len(jax.tree.leaves(
        jax.tree.map(lambda t: 0, tp)))
    for path, leaf in jflat:
        keys = [p.key for p in path]
        t = tp
        for k in keys:
            t = t[k]
        norm = keys[0] == "final_norm" or keys[1] in ("ln1", "ln2")
        want = jnp.asarray(leaf).astype(jnp.float32 if norm
                                        else jnp.dtype(dtype))
        assert t.dtype == (torch.float32 if norm else getattr(torch, dtype))
        assert tuple(t.shape) == leaf.shape
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(want, np.float32))
