"""The port's PagedEngine on the CPU against the JAX PagedEngine with its
Pallas kernels (interpret mode), on qwen2 and stablelm smoke configs with
the same weights (converted through numpy by ``params_from_jax``).

Each trace runs two waves through both engines: five greedy prompts
(one longer than two prefill chunks, two sharing a 16-token prefix,
8 new tokens, decode horizon 4), then a repeat of a wave-1 prompt (a
prefix hit) with an eos id taken from the JAX engine's own output for
it (an eos finish) and a new prompt on the shared prefix. The configs:
qwen2 and stablelm, minitron and nemotron (squared ReLU, LayerNorm), and
minitron at head dim 128 (``d^-1/2`` no power of two). ``check_refcounts``
runs after each wave.

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

from repro.configs.base import get_config as jax_config
from repro.models import api as japi
from repro.serve.engine import PagedEngine as JaxEngine
from repro.serve.engine import Request as JaxRequest
from repro_torch.configs.base import get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import transformer as T
from repro_torch.serve.engine import PagedEngine, Request

ENGINE_KW = dict(num_blocks=40, block_size=8, max_seq_len=64, max_running=4,
                 decode_batch=4, prefill_chunk=8, decode_horizon=4)
SOLE_LOGIT_ATOL = 1e-4
SOLE_CALL_AGREEMENT = 0.95          # share of calls within SOLE_LOGIT_ATOL
# the engines' configs: qwen2 and stablelm (SwiGLU), minitron and nemotron
# (squared ReLU, LayerNorm), and minitron's smoke variant at head dim 128,
# where d^-1/2 is no power of two
NAMES = ("qwen2_0_5b", "stablelm_1_6b", "minitron_8b", "nemotron_4_15b",
         "minitron_8b-hd128")


def _smoke_configs(name):
    """(JAX, port) smoke configs of ``name`` (``<arch>-hd128``: at head
    dim 128)."""
    arch, _, variant = name.partition("-")
    kw = dict(head_dim=128) if variant == "hd128" else {}
    return (dataclasses.replace(jax_config(arch).smoke(), **kw),
            dataclasses.replace(get_config(arch).smoke(), **kw))


def _configs(name, mode):
    jcfg, tcfg = _smoke_configs(name)
    if mode == "exact":
        kw = dict(softmax_mode="exact", norm_mode="exact", logit_int8=False)
        jcfg, tcfg = (dataclasses.replace(jcfg, **kw),
                      dataclasses.replace(tcfg, **kw))
    return jcfg, tcfg


@pytest.fixture(scope="module")
def jax_params():
    return {name: japi.init_params(0, _smoke_configs(name)[0])[0] for name in NAMES}


def _waves(vocab, seed):
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, 16)
    prompts = [rng.integers(0, vocab, n) for n in (5, 20, 11)]
    prompts += [np.concatenate([shared, rng.integers(0, vocab, n)])
                for n in (3, 9)]
    tail = np.concatenate([shared, rng.integers(0, vocab, 6)])
    return [p.astype(np.int32) for p in prompts], tail.astype(np.int32)


def _serve(engine, request_cls, prompts, tail, eos):
    """Both waves through one engine; returns (outputs, finish reasons)."""
    outs = engine.generate([request_cls(prompt=p, max_new_tokens=8)
                            for p in prompts])
    if eos is None:
        return outs, None
    outs += engine.generate([
        request_cls(prompt=prompts[1], max_new_tokens=8, eos_ids=(eos,)),
        request_cls(prompt=tail, max_new_tokens=8)])
    return outs, engine.stats()["finish_reasons"]


def _wave2_eos(jcfg, params, prompts, tail, jw1):
    """The eos id of wave 2's repeated request: the third token the JAX
    engine draws for it there. In exact mode that is its wave-1 token; in
    SOLE mode a norm calibrates over the whole chunk or batch, and the
    prefix hit changes both, so a first JAX pass of the same steps (wave
    1 twice, then wave 2 with no eos) picks it."""
    if jcfg.softmax_mode == "exact" and jcfg.norm_mode == "exact":
        return int(jw1[1][2])
    dry = JaxEngine(jcfg, params, backend="pallas", **ENGINE_KW)
    for _ in range(2):
        dry.generate([JaxRequest(prompt=p, max_new_tokens=8)
                      for p in prompts])
    out = dry.generate([JaxRequest(prompt=prompts[1], max_new_tokens=8),
                        JaxRequest(prompt=tail, max_new_tokens=8)])
    return int(out[0][2])


def _record_calls(monkeypatch):
    """Record every prefill_paged / decode_step_paged call of the port's
    model: its inputs and pools before the call (numpy) and its logits."""
    calls = []

    def snap(pools):
        return {k: v.clone().numpy() for k, v in pools.items()}

    orig_prefill, orig_decode = T.prefill_paged, T.decode_step_paged

    def prefill(params, tokens, q_start, n_valid, tables, pools, cfg):
        before = snap(pools)
        logits, pools = orig_prefill(params, tokens, q_start, n_valid,
                                     tables, pools, cfg)
        calls.append(("prefill", (tokens.numpy(), q_start.numpy(),
                                  n_valid.numpy(), tables.numpy()), before,
                      logits.numpy()))
        return logits, pools

    def decode(params, pools, token, pos, tables, cfg):
        before = snap(pools)
        logits, pools = orig_decode(params, pools, token, pos, tables, cfg)
        calls.append(("decode", (token.numpy(), pos.numpy(),
                                 tables.numpy()), before, logits.numpy()))
        return logits, pools

    monkeypatch.setattr(T, "prefill_paged", prefill)
    monkeypatch.setattr(T, "decode_step_paged", decode)
    return calls


def _replay_on_jax(calls, jcfg, params):
    """Max |logits_port - logits_jax| per recorded call, the JAX model run
    with its Pallas kernels on the same inputs and pools."""
    prefill = jax.jit(lambda p, t, qs, nv, refs, st: japi.prefill_paged(
        p, t, qs, nv, refs, st, jcfg, backend="pallas")[0])
    decode = jax.jit(lambda p, t, pos, refs, st: japi.decode_step_paged(
        p, t, pos, refs, st, jcfg, backend="pallas")[0])
    errs = []
    for kind, args, pools, logits in calls:
        state = {k: jnp.asarray(v) for k, v in pools.items()}
        if kind == "prefill":
            tokens, q_start, n_valid, tables = map(jnp.asarray, args)
            want = prefill(params, tokens, q_start, n_valid,
                           {"tables": tables}, state)
        else:
            token, pos, tables = map(jnp.asarray, args)
            want = decode(params, token, pos, {"tables": tables}, state)
        errs.append(float(np.abs(logits - np.asarray(want)).max()))
    return errs


@pytest.mark.parametrize("mode", ["exact", "sole"])
@pytest.mark.parametrize("name", NAMES)
def test_engine_matches_jax_engine(name, mode, jax_params, monkeypatch):
    jcfg, tcfg = _configs(name, mode)
    params = jax_params[name]
    tparams = params_from_jax(jax.tree.map(np.asarray, params), tcfg, "cpu")
    prompts, tail = _waves(tcfg.vocab_size, seed=len(name))
    jeng = JaxEngine(jcfg, params, backend="pallas", **ENGINE_KW)
    teng = PagedEngine(tcfg, tparams, device="cpu", **ENGINE_KW)
    calls = _record_calls(monkeypatch) if mode == "sole" else None

    jw1, _ = _serve(jeng, JaxRequest, prompts, tail, None)
    tw1, _ = _serve(teng, Request, prompts, tail, None)
    teng.cache.check_refcounts()
    eos = _wave2_eos(jcfg, params, prompts, tail, jw1)
    jout, jreasons = _serve(jeng, JaxRequest, prompts, tail, eos)
    tout, treasons = _serve(teng, Request, prompts, tail, eos)
    teng.cache.check_refcounts()

    assert tw1 == jw1
    assert tout == jout
    assert treasons == jreasons and treasons.get("eos") == 1
    assert len(tout[-2]) < 8 and tout[-2][-1] == eos
    stats = teng.stats()
    assert stats["prefix_hit_tokens"] >= 16 + len(prompts[1]) - 1
    assert stats["decode_dispatches"] < stats["decode_tokens"]  # horizon > 1
    if calls is not None:
        kinds = {c[0] for c in calls}
        assert kinds == {"prefill", "decode"}
        errs = np.asarray(_replay_on_jax(calls, jcfg, params))
        agree = (errs <= SOLE_LOGIT_ATOL).mean()
        assert agree >= SOLE_CALL_AGREEMENT, errs


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
