"""Shared set-up of the paged-engine parity tests (``tests/test_torch_engine*.py``,
one file per config so the workers share them): the smoke configs, the
two waves of requests, the recorder of the port's model calls and their
replay through the JAX model. The case itself, and what it asserts, is
described in ``tests/test_torch_engine.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

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


def jax_params_of(names):
    """JAX ``init_params(0)`` of each named smoke config."""
    return {name: japi.init_params(0, _smoke_configs(name)[0])[0]
            for name in names}


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


def engine_case(name, mode, jax_params, monkeypatch):
    """One config's two-wave trace through both engines (see
    ``tests/test_torch_engine.py``)."""
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
