"""The port's W8A8 ``PagedEngine`` on the CPU against the JAX
``PagedEngine`` (paged attention through its Pallas kernel in interpret
mode), on the qwen2 and stablelm smoke configs with the same float32
master weights: both engines pack the int8 codes themselves.

Each trace is the one of ``tests/test_torch_engine.py``: five greedy
prompts (one longer than two prefill chunks, two sharing a 16-token
prefix, 8 new tokens, decode horizon 4), then a repeat of a wave-1 prompt
with an eos id from the JAX engine's output and a new prompt on the shared
prefix; ``check_refcounts`` after each wave.

* w8a8, with float KV pages ("auto") and with int8 KV pages:
  - exact mode: greedy tokens and finish reasons equal; the int32 sums
    make the port's decode horizon 1 equal its horizon 8.
  - SOLE mode: tokens equal, and every ``prefill_paged`` /
    ``decode_step_paged`` call the port made, replayed through the JAX
    model on the same inputs and pools, gives logits within 1e-4 in at
    least 95% of the calls. For the replay the JAX norms take a correctly
    rounded ``1 / sqrt`` in place of ``jax.lax.rsqrt``: XLA's CPU rsqrt is
    approximate (it differs from ``1 / sqrt`` on ~36% of float32 inputs),
    and at w8a8 that last bit matters. A SOLE norm's output is an integer
    code times one row factor, so its per-row int8 codes land exactly on
    rounding ties (~2.5% of elements on the qwen2 trace) and the last bit
    of the row factor decides them; one flipped activation code moves
    logits by ~1e-2. With XLA's rsqrt the qwen2 trace agrees in only
    19-36% of its calls; with ``1 / sqrt`` in 98-100%, the rest being the
    one-ulp flips of a PTF or activation code that the float trace of
    ``tests/test_torch_engine.py`` shows too.
* w8a16, exact mode: tokens equal.
* quant off: the float path is untouched (no packed leaf, no int8 GEMM
  call) and its tokens equal the JAX engine's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import QuantConfig as JaxQuantConfig
from repro.configs.base import get_config as jax_config
from repro.models import api as japi
from repro.serve.engine import PagedEngine as JaxEngine
from repro.serve.engine import Request as JaxRequest
from repro_torch.configs.base import QuantConfig, get_config
from repro_torch.convert import params_from_jax
from repro_torch.core.sole.quant import is_qtensor
from repro_torch.kernels import int8_matmul as KM
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


@pytest.fixture(scope="module")
def jax_params():
    return {name: japi.init_params(0, jax_config(name).smoke())[0]
            for name in ("qwen2_0_5b", "stablelm_1_6b")}


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


@pytest.mark.parametrize("kv", ["auto", "int8"])
@pytest.mark.parametrize("mode", ["exact", "sole"])
@pytest.mark.parametrize("name", ["qwen2_0_5b", "stablelm_1_6b"])
def test_w8a8_engine_matches_jax_engine(name, mode, kv, jax_params,
                                        monkeypatch):
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


@pytest.mark.parametrize("kv", ["auto", "int8"])
def test_w8a8_decode_horizon_invariant(kv, jax_params):
    """Exact mode: the port's horizon-1 and horizon-8 engines give the
    same tokens (every w8a8 sum is an exact int32 sum), equal to the JAX
    engine's at horizon 8."""
    outs = []
    for horizon in (1, 8):
        _, tcfg, jeng, teng = _engines("qwen2_0_5b", "exact", "w8a8", kv,
                                       jax_params, decode_horizon=horizon)
        prompts, _ = _waves(tcfg.vocab_size, seed=3)
        outs.append(_serve(teng, Request, prompts, None, None))
        teng.cache.check_refcounts()
    assert outs[0] == outs[1]
    assert outs[1] == _serve(jeng, JaxRequest, prompts, None, None)


@pytest.mark.parametrize("name", ["qwen2_0_5b", "stablelm_1_6b"])
def test_w8a16_engine_matches_jax_engine(name, jax_params):
    _, tcfg, jeng, teng = _engines(name, "exact", "w8a16", "auto",
                                   jax_params)
    prompts, tail = _waves(tcfg.vocab_size, seed=len(name))
    jout, tout, _ = _both_waves(jeng, teng, prompts, tail)
    assert tout == jout


def test_quant_off_path_unchanged(jax_params):
    """quant "off": float weights, no packed leaf, no int8 GEMM call, and
    the JAX engine's tokens."""
    _, tcfg, jeng, teng = _engines("qwen2_0_5b", "exact", "off", "auto",
                                   jax_params)
    flat = jax.tree_util.tree_leaves(teng.params)
    assert all(t.dtype == torch.float32 for t in flat)
    assert not is_qtensor(teng.params["embed"]["head"])
    before = KM.int8_matmul.launches
    prompts, tail = _waves(tcfg.vocab_size, seed=5)
    jout, tout, _ = _both_waves(jeng, teng, prompts, tail)
    assert tout == jout
    assert KM.int8_matmul.launches == before
