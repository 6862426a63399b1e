"""The port's dense-slot ``Engine`` on the CPU against the JAX ``Engine``,
on the qwen2 and stablelm smoke configs with the same weights (converted
through numpy by ``params_from_jax``). The JAX engine has no backend
argument: its config carries ``ops_backend="pallas"``, so its SOLE softmax
and norms run their Pallas kernels in interpret mode, as the JAX
package's own CPU tests run them.

The trace: six greedy prompts of mixed lengths (5, 20, 11, 3, 16, 9
tokens, 8 new tokens) served four at a time, so the first batch is
left-padded to 20 and the second is a ragged final chunk of two requests
padded with two zero-budget lanes; request 1 carries an eos id taken from
the JAX engine's own output on a first pass.

* exact mode: greedy tokens and ``finish_reasons`` equal, in float and at
  w8a8 with an int8 dense cache.
* SOLE mode: every ``prefill``/``decode_step`` call the port made is
  replayed through the jitted JAX model on the same inputs and cache.
  Logits agree to 1e-4 where no code flips (float32 sums in another
  order; XLA's inexact ``exp2`` of integers); a one-ulp difference can
  move a PTF or int8-snap code across its rounding boundary and the
  logits by ~1e-2, so at least 95% of the calls agree to 1e-4, and the
  greedy tokens are equal.
* ``forward``: within 1e-4 of the JAX ``forward`` in exact mode; in SOLE
  mode at least 95% of the (sequence, position) rows within 1e-4.
* the launcher serves ``--smoke`` on the CPU through both engines, each
  request getting exactly ``--new-tokens`` tokens.
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
from repro.serve.engine import Engine as JaxEngine
from repro.serve.engine import Request as JaxRequest
from repro_torch.configs.base import QuantConfig, get_config
from repro_torch.convert import params_from_jax
from repro_torch.core.sole.quant import is_qtensor
from repro_torch.kernels import e2softmax as KE
from repro_torch.launch import serve as launcher
from repro_torch.models import api
from repro_torch.models import transformer as T
from repro_torch.serve.engine import Engine, Request

BATCH = 4
MAX_LEN = 32
NEW_TOKENS = 8
PROMPT_LENS = (5, 20, 11, 3, 16, 9)
SOLE_LOGIT_ATOL = 1e-4
SOLE_CALL_AGREEMENT = 0.95          # share of calls within SOLE_LOGIT_ATOL
# qwen2 and stablelm (SwiGLU), minitron and nemotron (squared ReLU,
# LayerNorm), and minitron's smoke variant at head dim 128, where d^-1/2
# is no power of two
NAMES = ("qwen2_0_5b", "stablelm_1_6b", "minitron_8b", "nemotron_4_15b",
         "minitron_8b-hd128")


def _smoke_configs(name):
    """(JAX, port) smoke configs of ``name`` (``<arch>-hd128``: at head
    dim 128)."""
    arch, _, variant = name.partition("-")
    kw = dict(head_dim=128) if variant == "hd128" else {}
    return (dataclasses.replace(jax_config(arch).smoke(), **kw),
            dataclasses.replace(get_config(arch).smoke(), **kw))


def _configs(name, mode, quant="off", kv="auto"):
    kw = dict(kv_cache_dtype=kv)
    if mode == "exact":
        kw.update(softmax_mode="exact", norm_mode="exact", logit_int8=False)
    jcfg, tcfg = _smoke_configs(name)
    jcfg = dataclasses.replace(jcfg, ops_backend="pallas",
                               quant=JaxQuantConfig(quant), **kw)
    tcfg = dataclasses.replace(tcfg, quant=QuantConfig(quant), **kw)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def jax_params():
    return {name: japi.init_params(0, _smoke_configs(name)[0])[0] for name in NAMES}


def _prompts(vocab, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in PROMPT_LENS]


def _requests(cls, prompts, eos=None):
    return [cls(prompt=p, max_new_tokens=NEW_TOKENS,
                eos_ids=(eos,) if eos is not None and i == 1 else ())
            for i, p in enumerate(prompts)]


def _engines(name, mode, jax_params, **kw):
    jcfg, tcfg = _configs(name, mode, **kw)
    params = jax_params[name]
    tparams = params_from_jax(jax.tree.map(np.asarray, params), tcfg, "cpu")
    jeng = JaxEngine(jcfg, params, batch_size=BATCH, max_len=MAX_LEN)
    teng = Engine(tcfg, tparams, batch_size=BATCH, max_len=MAX_LEN,
                  device="cpu")
    return jcfg, tcfg, jeng, teng


def _serve_both(jeng, teng, prompts):
    """A first JAX pass picks request 1's eos id (its third token); then
    both engines serve the trace with it. Returns (JAX outputs, port
    outputs, eos)."""
    eos = int(jeng.generate(_requests(JaxRequest, prompts))[1][2])
    jout = jeng.generate(_requests(JaxRequest, prompts, eos))
    tout = teng.generate(_requests(Request, prompts, eos))
    return jout, tout, eos


def _record_calls(monkeypatch):
    """Every prefill / decode_step call of the port's model: its inputs,
    the cache before the call (numpy) and its logits."""
    calls = []
    orig_prefill, orig_decode = T.prefill, T.decode_step

    def prefill(params, tokens, cfg, cache_len, n_pad=None):
        logits, cache = orig_prefill(params, tokens, cfg, cache_len,
                                     n_pad=n_pad)
        calls.append(("prefill", (tokens.numpy(), n_pad.numpy(), cache_len),
                      logits.numpy()))
        return logits, cache

    def decode(params, cache, token, pos, cfg, write_pos=None):
        before = {k: v.clone().numpy() for k, v in cache.items()}
        logits, cache = orig_decode(params, cache, token, pos, cfg,
                                    write_pos=write_pos)
        calls.append(("decode", (before, token.numpy(), pos.numpy(),
                                 write_pos), logits.numpy()))
        return logits, cache

    monkeypatch.setattr(T, "prefill", prefill)
    monkeypatch.setattr(T, "decode_step", decode)
    return calls


def _replay_on_jax(calls, jcfg, params):
    """Max |logits_port - logits_jax| per recorded call, through the jitted
    JAX model (its Pallas kernels in interpret mode)."""
    model = japi.get_model(jcfg)
    prefill = jax.jit(lambda p, t, n, cache_len: model.prefill(
        p, t, jcfg, cache_len, n_pad=n)[0], static_argnums=3)
    decode = jax.jit(lambda p, c, t, pos, wp: model.decode_step(
        p, c, t, pos, jcfg, write_pos=wp)[0])
    errs = []
    for kind, args, logits in calls:
        if kind == "prefill":
            tokens, n_pad, cache_len = args
            want = prefill(params, jnp.asarray(tokens), jnp.asarray(n_pad),
                           cache_len)
        else:
            cache, token, pos, write_pos = args
            want = decode(params, {k: jnp.asarray(v) for k, v in cache.items()},
                          jnp.asarray(token), jnp.asarray(pos),
                          jnp.asarray(write_pos, jnp.int32))
        errs.append(float(np.abs(logits - np.asarray(want)).max()))
    return errs


@pytest.mark.parametrize("mode", ["exact", "sole"])
@pytest.mark.parametrize("name", NAMES)
def test_engine_matches_jax_engine(name, mode, jax_params, monkeypatch):
    jcfg, tcfg, jeng, teng = _engines(name, mode, jax_params)
    prompts = _prompts(tcfg.vocab_size, seed=len(name))
    calls = _record_calls(monkeypatch) if mode == "sole" else None
    launches = KE.e2softmax.launches
    jout, tout, eos = _serve_both(jeng, teng, prompts)
    assert tout == jout
    assert teng.finish_reasons == jeng.finish_reasons
    assert teng.finish_reasons[1] == "eos" and tout[1][-1] == eos
    assert [len(o) for i, o in enumerate(tout) if i != 1] == [NEW_TOKENS] * 5
    assert teng.prefill_calls == 2
    assert KE.e2softmax.launches == launches     # CPU: the plain version
    if calls is not None:
        assert {c[0] for c in calls} == {"prefill", "decode"}
        assert len(calls) == teng.prefill_calls + teng.decode_calls
        errs = np.asarray(_replay_on_jax(calls, jcfg, jeng.params))
        agree = (errs <= SOLE_LOGIT_ATOL).mean()
        assert agree >= SOLE_CALL_AGREEMENT, errs


@pytest.mark.parametrize("name", NAMES)
def test_w8a8_int8_cache_engine_matches_jax_engine(name, jax_params):
    """Exact mode at w8a8 with an int8 dense cache: both engines pack the
    int8 weights from the same float32 masters; tokens equal."""
    _, tcfg, jeng, teng = _engines(name, "exact", jax_params, quant="w8a8",
                                   kv="int8")
    assert is_qtensor(teng.params["layers"]["attn"]["wq"])
    prompts = _prompts(tcfg.vocab_size, seed=len(name) + 1)
    jout, tout, _ = _serve_both(jeng, teng, prompts)
    assert tout == jout
    assert teng.finish_reasons == jeng.finish_reasons
    cache = api.init_cache(tcfg, BATCH, MAX_LEN, "cpu")
    assert cache["k"].dtype == torch.int8
    assert tuple(cache["k"].shape) == (tcfg.n_layers, BATCH, tcfg.n_kv_heads,
                                       tcfg.head_dim, MAX_LEN)
    assert tuple(cache["v"].shape) == (tcfg.n_layers, BATCH, tcfg.n_kv_heads,
                                       MAX_LEN, tcfg.head_dim)


@pytest.mark.parametrize("mode", ["exact", "sole"])
@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_jax(name, mode, jax_params):
    jcfg, tcfg = _configs(name, mode)
    params = jax_params[name]
    tparams = params_from_jax(jax.tree.map(np.asarray, params), tcfg, "cpu")
    tokens = np.random.default_rng(4).integers(
        0, tcfg.vocab_size, (2, 24)).astype(np.int32)
    want = np.asarray(jax.jit(lambda p, t: japi.forward(
        p, {"tokens": t}, jcfg, "serve"))(params, jnp.asarray(tokens)))
    got = api.forward(tparams, {"tokens": torch.from_numpy(tokens)}, tcfg,
                      "serve").numpy()
    assert got.shape == want.shape == (2, 24, tcfg.padded_vocab)
    rows = np.abs(got - want).max(-1)
    if mode == "exact":
        assert rows.max() <= 1e-4
    else:
        assert (rows <= SOLE_LOGIT_ATOL).mean() >= SOLE_CALL_AGREEMENT, rows


@pytest.mark.parametrize("engine", ["dense", "paged"])
def test_launcher_serves_on_the_cpu(engine, capsys):
    outs = launcher.main(["--arch", "qwen2_0_5b", "--smoke", "--device", "cpu",
                          "--engine", engine, "--requests", "5",
                          "--prompt-len", "12", "--new-tokens", "6"])
    assert [len(o) for o in outs] == [6] * 5
    assert f"engine={engine} device=cpu" in capsys.readouterr().out


def test_launcher_defaults_to_the_dense_engine_on_the_card():
    args = launcher.parse_args(["--arch", "qwen2_0_5b"])
    assert (args.engine, args.device) == ("dense", "cuda")


def _smoke():
    cfg = get_config("qwen2_0_5b").smoke()
    return cfg, api.init_params(0, cfg, "cpu")


def test_engine_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    cfg, params = _smoke()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(cfg, params)
    eng = Engine(cfg, params, device="cpu", batch_size=2, max_len=16)
    out = eng.generate([Request(prompt=np.arange(5, dtype=np.int32),
                                max_new_tokens=3)])
    assert len(out[0]) == 3 and eng.finish_reasons == ["length"]


@pytest.mark.parametrize("change,err,match", [
    (dict(family="moe", quant=QuantConfig("w8a8")), NotImplementedError,
     "no quantized MoE path"),
    (dict(family="ssm", quant=QuantConfig("w8a16")), ValueError,
     "no quantized serving path"),
    (dict(family="hybrid", kv_cache_dtype="int8"), NotImplementedError,
     "int8 KV"),
    (dict(family="encdec"), ValueError, "LM families")])
def test_engine_raises_for_unported_families(change, err, match):
    cfg, params = _smoke()
    with pytest.raises(err, match=match):
        Engine(dataclasses.replace(cfg, **change), params, device="cpu")


def test_engine_raises_for_rules_and_sampling():
    """The dense-slot engine serves mesh rules of every rank of the
    process group (``tests/test_torch_mesh_data.py``, the MoE family in
    ``tests/test_torch_mesh_moe.py``); a (1, 2) mesh in a process of its
    own raises for dense and MoE alike, and the recurrent families under
    rules (ROADMAP item 9.2b) raise."""
    from repro_torch.launch.mesh import Mesh, make_rules
    cfg, params = _smoke()
    rules = make_rules(Mesh((1, 2), ("data", "model")))
    for family in ("dense", "moe"):
        with pytest.raises(ValueError, match="in a process group of 1"):
            Engine(dataclasses.replace(cfg, family=family), params,
                   device="cpu", rules=rules)
    with pytest.raises(NotImplementedError, match="queue 1 item 9.2b"):
        Engine(dataclasses.replace(cfg, family="ssm"), params, device="cpu",
               rules=rules)
