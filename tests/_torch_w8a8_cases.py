"""Shared set-up of the port's W8A8 / W8A16 ``PagedEngine`` parity tests
(``tests/test_torch_w8a8_engine.py`` for qwen2_0_5b,
``tests/test_torch_w8a8_engine_stablelm.py`` for stablelm_1_6b; one file
per config so the workers share them): the configs, the two waves, the
recorder of the port's model calls, their replay through the JAX model and
the cases themselves. What each case asserts, and why the replay takes a
correctly rounded ``1 / sqrt``, is described in
``tests/test_torch_w8a8_engine.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.base import QuantConfig as JaxQuantConfig
from repro.configs.base import get_config as jax_config
from repro.models import api as japi
from repro.serve.engine import PagedEngine as JaxEngine
from repro.serve.engine import Request as JaxRequest
from repro_torch.configs.base import QuantConfig, get_config
from repro_torch.convert import params_from_jax
from repro_torch.core.sole.quant import is_qtensor
from repro_torch.models import transformer as T
from repro_torch.serve.engine import PagedEngine, Request

ENGINE_KW = dict(num_blocks=40, block_size=8, max_seq_len=64, max_running=4,
                 decode_batch=4, prefill_chunk=8, decode_horizon=4)
SOLE_LOGIT_ATOL = 1e-4
SOLE_CALL_AGREEMENT = 0.95          # share of calls within SOLE_LOGIT_ATOL


def _configs(name, mode, quant, kv):
    kw = dict(kv_cache_dtype=kv)
    if mode == "exact":
        kw.update(softmax_mode="exact", norm_mode="exact", logit_int8=False)
    jcfg = dataclasses.replace(jax_config(name).smoke(),
                               quant=JaxQuantConfig(quant), **kw)
    tcfg = dataclasses.replace(get_config(name).smoke(),
                               quant=QuantConfig(quant), **kw)
    return jcfg, tcfg


def jax_params_of(name):
    """JAX ``init_params(0)`` of ``name``'s smoke config, by name."""
    return {name: japi.init_params(0, jax_config(name).smoke())[0]}


def _waves(vocab, seed):
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, 16)
    prompts = [rng.integers(0, vocab, n) for n in (5, 20, 11)]
    prompts += [np.concatenate([shared, rng.integers(0, vocab, n)])
                for n in (3, 9)]
    tail = np.concatenate([shared, rng.integers(0, vocab, 6)])
    return [p.astype(np.int32) for p in prompts], tail.astype(np.int32)


def _serve(engine, request_cls, prompts, tail, eos):
    """Wave 1, or wave 2 when ``eos`` is given; returns the outputs."""
    if eos is None:
        return engine.generate([request_cls(prompt=p, max_new_tokens=8)
                                for p in prompts])
    return engine.generate([
        request_cls(prompt=prompts[1], max_new_tokens=8, eos_ids=(eos,)),
        request_cls(prompt=tail, max_new_tokens=8)])


def _both_waves(jeng, teng, prompts, tail):
    jw1 = _serve(jeng, JaxRequest, prompts, tail, None)
    tw1 = _serve(teng, Request, prompts, tail, None)
    teng.cache.check_refcounts()
    eos = int(jw1[1][2])
    jw2 = _serve(jeng, JaxRequest, prompts, tail, eos)
    tw2 = _serve(teng, Request, prompts, tail, eos)
    teng.cache.check_refcounts()
    return jw1 + jw2, tw1 + tw2, eos


def _record_calls(monkeypatch):
    """Every prefill_paged / decode_step_paged call of the port's model:
    its inputs and pools before the call (numpy) and its logits."""
    calls = []

    def snap(pools):
        return {k: v.clone().numpy() for k, v in pools.items()}

    orig_prefill, orig_decode = T.prefill_paged, T.decode_step_paged

    def prefill(params, tokens, q_start, n_valid, tables, pools, cfg, **kw):
        before = snap(pools)
        logits, pools = orig_prefill(params, tokens, q_start, n_valid,
                                     tables, pools, cfg, **kw)
        calls.append(("prefill", (tokens.numpy(), q_start.numpy(),
                                  n_valid.numpy(), tables.numpy()), before,
                      logits.numpy()))
        return logits, pools

    def decode(params, pools, token, pos, tables, cfg, **kw):
        before = snap(pools)
        logits, pools = orig_decode(params, pools, token, pos, tables, cfg,
                                    **kw)
        calls.append(("decode", (token.numpy(), pos.numpy(),
                                 tables.numpy()), before, logits.numpy()))
        return logits, pools

    monkeypatch.setattr(T, "prefill_paged", prefill)
    monkeypatch.setattr(T, "decode_step_paged", decode)
    return calls


def _rounded_rsqrt(v):
    # the barrier keeps XLA from folding 1 / sqrt back into its rsqrt
    return 1.0 / jax.lax.optimization_barrier(jnp.sqrt(v))


def _replay_on_jax(calls, jcfg, params, monkeypatch):
    """Max |logits_port - logits_jax| per recorded call, the JAX model (its
    already packed weights) with paged attention through Pallas and its
    norms' rsqrt correctly rounded (see the module docstring)."""
    with monkeypatch.context() as m:
        m.setattr(jax.lax, "rsqrt", _rounded_rsqrt)
        jax.clear_caches()
        try:
            return _replay(calls, jcfg, params)
        finally:
            jax.clear_caches()


def _replay(calls, jcfg, params):
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


def _engines(name, mode, quant, kv, jax_params, **kw):
    jcfg, tcfg = _configs(name, mode, quant, kv)
    params = jax_params[name]
    tparams = params_from_jax(jax.tree.map(np.asarray, params), tcfg, "cpu")
    engine_kw = dict(ENGINE_KW, **kw)
    jeng = JaxEngine(jcfg, params, backend="pallas", **engine_kw)
    teng = PagedEngine(tcfg, tparams, device="cpu", **engine_kw)
    return jcfg, tcfg, jeng, teng


def w8a8_case(name, mode, kv, jax_params, monkeypatch):
    jcfg, tcfg, jeng, teng = _engines(name, mode, "w8a8", kv, jax_params)
    assert is_qtensor(teng.params["layers"]["attn"]["wo"])
    want = torch.int8 if kv == "int8" else torch.float32
    assert {p.dtype for p in teng.cache.pools.values()} == {want}
    calls = _record_calls(monkeypatch) if mode == "sole" else None
    prompts, tail = _waves(tcfg.vocab_size, seed=len(name))
    jout, tout, eos = _both_waves(jeng, teng, prompts, tail)
    assert tout == jout
    reasons = teng.stats()["finish_reasons"]
    assert reasons == jeng.stats()["finish_reasons"]
    assert reasons.get("eos") == 1 and tout[-2][-1] == eos
    if calls is not None:
        assert {c[0] for c in calls} == {"prefill", "decode"}
        errs = np.asarray(_replay_on_jax(calls, jcfg, jeng.params,
                                         monkeypatch))
        agree = (errs <= SOLE_LOGIT_ATOL).mean()
        assert agree >= SOLE_CALL_AGREEMENT, errs


def w8a16_case(name, jax_params):
    _, tcfg, jeng, teng = _engines(name, "exact", "w8a16", "auto",
                                   jax_params)
    prompts, tail = _waves(tcfg.vocab_size, seed=len(name))
    jout, tout, _ = _both_waves(jeng, teng, prompts, tail)
    assert tout == jout
