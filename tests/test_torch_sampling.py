"""The port's counter-keyed sampler (``serve/sampling.py``) against the
JAX package's, and the engines that use it.

* The threefry2x32 chain: the random bits of ``fold_in(PRNGKey(seed),
  n)`` equal ``jax.random.bits`` exactly, on the host (numpy) and in
  torch, over seeds 0 .. 2**32 - 1 and counters up to 10**6.
* Gumbel noise: each side takes its ``log``s in its own way (XLA's
  float32 ``log``, off by an ulp on ~14% of inputs; the port's float64
  ``log`` rounded to float32), so the floats agree to an ulp of the
  result plus the inner ``log``'s ulp carried through the outer one
  (2**-23 absolute); numpy and torch agree bit for bit.
* Draws: ``sample_tokens`` equals the JAX ``sample_tokens`` on random
  logits and on logits with ties (top-k keeps the lower indices), over
  temperatures (0 included) and top-k; the host ``Sampler`` equals it.
* Engines: ``PagedEngine`` and ``Engine`` on smoke configs at
  temperature 0.7, top-k 5 give the JAX engines' tokens (exact mode);
  cold, warm-cache and preempted replays give the same tokens; an
  all-greedy batch samples with one argmax.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_config
from repro.models import api as japi
from repro.serve import sampling as JS
from repro.serve.engine import Engine as JaxEngine
from repro.serve.engine import PagedEngine as JaxPagedEngine
from repro.serve.engine import Request as JaxRequest
from repro_torch.configs.base import get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import api
from repro_torch.serve import sampling as TS
from repro_torch.serve.engine import Engine, PagedEngine, Request

SEEDS = (0, 1, 12345, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1)
COUNTERS = (0, 1, 7, 1000, 10 ** 6)
GUMBEL_ABS = 2.0 ** -23
ENGINE_KW = dict(num_blocks=40, block_size=8, max_seq_len=64, max_running=4,
                 decode_batch=4, prefill_chunk=8, decode_horizon=4)
SAMPLE = dict(temperature=0.7, top_k=5)


def _jax_bits(seed, counter, n):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), counter)
    return np.asarray(jax.random.bits(key, (n,), jnp.uint32))


@pytest.mark.parametrize("counter", COUNTERS)
@pytest.mark.parametrize("seed", SEEDS)
def test_threefry_bits_equal_jax(seed, counter):
    want = _jax_bits(seed, counter, 1001)
    np.testing.assert_array_equal(TS.random_bits(seed, counter, 1001), want)
    k0, k1 = TS.fold_in_key(torch.tensor([seed]), torch.tensor([counter]))
    idx = torch.arange(1001)
    b0, b1 = TS.threefry2x32(k0, k1, torch.zeros_like(idx), idx)
    np.testing.assert_array_equal((b0 ^ b1).numpy().astype(np.uint32), want)


@pytest.mark.parametrize("seed,counter", [(0, 0), (5, 3), (2 ** 32 - 1, 10 ** 6)])
def test_gumbel_within_an_ulp_of_xla(seed, counter):
    n = 200_000
    want = np.asarray(JS._gumbel_row(seed, counter, n))
    got = TS.gumbel_row(seed, counter, n)
    dev = TS.gumbel_rows(torch.tensor([seed]), torch.tensor([counter]), n)
    np.testing.assert_array_equal(dev[0].numpy(), got)
    bound = np.spacing(np.abs(want)) + GUMBEL_ABS
    assert (np.abs(got - want) <= bound).all()
    assert (got == want).mean() > 0.5


def _logits(seed, b=6, v=1024):
    rng = np.random.default_rng(seed)
    z = (rng.standard_normal((b, v)) * 3).astype(np.float32)
    z[:, :200] = np.round(z[:, :200])          # many ties
    z[1, :] = 1.0                              # a row of one value
    return z


LANES = dict(temperature=np.array([0.0, 0.7, 1.0, 0.3, 2.0, 0.7], np.float32),
             top_k=np.array([0, 5, 0, 1, 40, 2000], np.int32),
             seed=np.array([0, 1, 2 ** 32 - 1, 7, 9, 12], np.uint32),
             counter=np.array([0, 3, 7, 100, 1, 10 ** 6], np.int32))


@pytest.mark.parametrize("use_top_k,stochastic",
                         [(True, True), (False, True), (True, False),
                          (False, False)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sample_tokens_equal_jax(seed, use_top_k, stochastic):
    z = _logits(seed)
    vocab = 1000
    lanes = dict(LANES)
    if not use_top_k:
        lanes["top_k"] = np.zeros(6, np.int32)
    if not stochastic:
        lanes["temperature"] = np.zeros(6, np.float32)
    want = np.asarray(JS.sample_tokens(
        jnp.asarray(z), *(jnp.asarray(lanes[k]) for k in LANES), vocab,
        use_top_k=use_top_k, stochastic=stochastic))
    t = [torch.from_numpy(lanes[k].astype(np.float32 if k == "temperature"
                                          else np.int64)) for k in LANES]
    got = TS.sample_tokens(torch.from_numpy(z), *t, vocab,
                           use_top_k=use_top_k, stochastic=stochastic)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    for i in range(6):
        host = TS.Sampler(temperature=float(lanes["temperature"][i]),
                          top_k=int(lanes["top_k"][i]),
                          seed=int(lanes["seed"][i]), vocab_size=vocab)
        assert host.draw(z[i], int(lanes["counter"][i])) == want[i]


def test_sampler_matches_jax_sampler_stream():
    """The host Sampler's stream (counter advancing per stochastic call,
    not per greedy one) equals the JAX Sampler's, draw by draw."""
    z = _logits(3)[0]
    for kw in (dict(temperature=0.9, top_k=3, seed=4),
               dict(temperature=1.5, seed=2 ** 32 + 5),
               dict(temperature=0.0, top_k=2, seed=1)):
        js, ts = JS.Sampler(vocab_size=1000, **kw), TS.Sampler(
            vocab_size=1000, **kw)
        assert [ts(z) for _ in range(12)] == [js(z) for _ in range(12)]
        assert ts.draws == js.draws
        ts.skip(5)
        js.skip(5)
        assert ts(z) == js(z)


def test_sampler_rejects_bad_arguments():
    with pytest.raises(ValueError, match="temperature"):
        TS.Sampler(temperature=-1.0)
    with pytest.raises(ValueError, match="top_k"):
        TS.Sampler(top_k=-2)


def _configs(name):
    kw = dict(softmax_mode="exact", norm_mode="exact", logit_int8=False)
    return (dataclasses.replace(jax_config(name).smoke(), **kw),
            dataclasses.replace(get_config(name).smoke(), **kw))


@pytest.fixture(scope="module")
def engines_params():
    out = {}
    for name in ("qwen2_0_5b", "minitron_8b"):
        jcfg, tcfg = _configs(name)
        params = japi.init_params(0, jcfg)[0]
        out[name] = (jcfg, tcfg, params, params_from_jax(
            jax.tree.map(np.asarray, params), tcfg, "cpu"))
    return out


def _prompts(vocab, seed):
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, 16)
    prompts = [rng.integers(0, vocab, n) for n in (5, 20, 11)]
    prompts += [np.concatenate([shared, rng.integers(0, vocab, n)])
                for n in (3, 9)]
    return [p.astype(np.int32) for p in prompts]


def _requests(cls, prompts, **kw):
    return [cls(prompt=p, max_new_tokens=8, seed=100 + i, **dict(SAMPLE, **kw))
            for i, p in enumerate(prompts)]


@pytest.mark.parametrize("name", ["qwen2_0_5b", "minitron_8b"])
def test_paged_engine_samples_the_jax_engines_tokens(name, engines_params):
    jcfg, tcfg, params, tparams = engines_params[name]
    prompts = _prompts(tcfg.vocab_size, len(name))
    want = JaxPagedEngine(jcfg, params, backend="pallas",
                          **ENGINE_KW).generate(_requests(JaxRequest, prompts))
    eng = PagedEngine(tcfg, tparams, device="cpu", **ENGINE_KW)
    got = eng.generate(_requests(Request, prompts))
    assert got == want
    assert eng.stats()["decode_dispatches"] < eng.stats()["decode_tokens"]
    greedy = PagedEngine(tcfg, tparams, device="cpu", **ENGINE_KW).generate(
        _requests(Request, prompts, temperature=0.0))
    assert greedy != got


@pytest.mark.parametrize("name", ["qwen2_0_5b", "minitron_8b"])
def test_dense_engine_samples_the_jax_engines_tokens(name, engines_params):
    jcfg, tcfg, params, tparams = engines_params[name]
    prompts = _prompts(tcfg.vocab_size, len(name) + 1)
    jeng = JaxEngine(dataclasses.replace(jcfg, ops_backend="pallas"), params,
                     batch_size=4, max_len=32)
    want = jeng.generate(_requests(JaxRequest, prompts))
    got = Engine(tcfg, tparams, batch_size=4, max_len=32,
                 device="cpu").generate(_requests(Request, prompts))
    assert got == want


def test_replays_cold_warm_and_preempted_are_identical(engines_params):
    _, tcfg, _, tparams = engines_params["qwen2_0_5b"]
    prompts = _prompts(tcfg.vocab_size, 11)
    reqs = _requests(Request, prompts)
    eng = PagedEngine(tcfg, tparams, device="cpu", **ENGINE_KW)
    cold = eng.generate(reqs)
    warm = eng.generate(reqs)
    assert eng.stats()["prefix_hit_tokens"] > 0
    tight = PagedEngine(tcfg, tparams, device="cpu",
                        **dict(ENGINE_KW, num_blocks=8, watermark=0))
    preempted = tight.generate(reqs)
    assert tight.stats()["preemptions"] > 0
    tight.cache.check_refcounts()
    assert cold == warm == preempted


def test_greedy_horizon_ships_no_sampling_tensors(monkeypatch):
    """An all-greedy decode batch samples with the argmax alone: the
    sampling tensors are never built and the rank sort and Gumbel rows
    never run."""
    cfg = get_config("qwen2_0_5b").smoke()
    params = api.init_params(0, cfg, "cpu")
    seen = []
    orig = TS.sample_tokens

    def spy(logits, temperature, top_k, seed, counter, vocab, **kw):
        seen.append((temperature, kw))
        return orig(logits, temperature, top_k, seed, counter, vocab, **kw)

    from repro_torch.models import transformer as T
    monkeypatch.setattr(T, "sample_tokens", spy)
    monkeypatch.setattr(TS, "gumbel_rows", None)
    monkeypatch.setattr(TS, "top_k_mask", None)
    eng = PagedEngine(cfg, params, device="cpu", **ENGINE_KW)
    out = eng.generate([Request(prompt=np.arange(6, dtype=np.int32),
                                max_new_tokens=6)])
    assert len(out[0]) == 6 and seen
    assert all(t is None and kw == dict(use_top_k=False, stochastic=False)
               for t, kw in seen)


def test_launcher_samples_on_the_cpu(capsys):
    from repro_torch.launch import serve as launcher
    argv = ["--arch", "minitron_8b", "--smoke", "--device", "cpu",
            "--temperature", "0.7", "--top-k", "5", "--requests", "3",
            "--prompt-len", "6", "--new-tokens", "4"]
    outs = launcher.main(argv + ["--engine", "paged"])
    assert [len(o) for o in outs] == [4] * 3
    assert launcher.main(argv) == outs
    assert "temperature=0.7, top_k=5" in capsys.readouterr().out
