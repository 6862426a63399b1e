"""The port's blocked (online-normalized) attention ``attend_blocked``
against the JAX package's jnp function (jitted, as the models run it),
on the same numpy-seeded q/k/v, and the whole models under
``attn_impl="blocked"``.

Cases: S 40-200 at ``attn_block`` 32 (padded q and k blocks), causal and
not, GQA 4/2 and MHA, the sliding-window band branch (window 48), head
dims 16 and 128, exact and SOLE mode.

Tolerances, absolute, of the largest output (at least 1):

* exact mode: 1e-5 (float32 sums in another order; XLA's CPU ``exp2``);
* SOLE, where ``d^-1/2`` is a power of two (head dim 16): 2e-6 (the
  codes are equal; XLA's CPU ``exp2`` of an integer is off by up to
  5.4e-7 relative, the port builds powers of two from exponent bits);
* SOLE at head dim 128 (``d^-1/2 = 2^-3.5``): the scaled q rounds, so a
  logit may cross an int8-snap rounding boundary and flip a code: at
  least 95% of the rows within 2e-6.

Models: ``api.forward`` and ``api.prefill`` (logits and cache) with
``attn_impl="blocked"`` against the JAX model, within 1e-4 in exact
mode; in SOLE mode at least 95% of the rows within 1e-4 (a one-ulp
difference can move a norm's PTF code).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_config
from repro.models import api as japi
from repro.models import layers as JL
from repro_torch.configs.base import get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import api
from repro_torch.models import layers as TL

# (S, head_dim, heads, kv heads, window, causal)
CASES = {"s40_gqa": (40, 16, 4, 2, 0, True),
         "s200_gqa": (200, 16, 4, 2, 0, True),
         "s130_mha_noncausal": (130, 16, 4, 4, 0, False),
         "s72_gqa_noncausal": (72, 16, 4, 2, 0, False),
         "s200_window48": (200, 16, 4, 2, 48, True),
         "s96_window48_mha": (96, 16, 4, 4, 48, True),
         "s100_hd128": (100, 128, 4, 2, 0, True),
         "s64_hd128_mha": (64, 128, 4, 4, 0, True)}
EXACT_TOL = 1e-5
SOLE_TOL = 2e-6
SHARE = 0.95
MODEL_TOL = 1e-4


def _configs(mode, **kw):
    kw = dict(kw, attn_block=32, softmax_mode=mode)
    if mode == "exact":
        kw.update(norm_mode="exact", logit_int8=False)
    return (dataclasses.replace(jax_config("qwen2_0_5b").smoke(), **kw),
            dataclasses.replace(get_config("qwen2_0_5b").smoke(), **kw))


def _qkv(name, s, hd, h, kv):
    rng = np.random.default_rng(len(name))
    q = rng.standard_normal((2, s, h, hd)).astype(np.float32) * 2
    k = rng.standard_normal((2, s, kv, hd)).astype(np.float32)
    v = rng.standard_normal((2, s, kv, hd)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("mode", ["exact", "sole"])
@pytest.mark.parametrize("name", list(CASES))
def test_attend_blocked_matches_reference(name, mode):
    s, hd, h, kv, window, causal = CASES[name]
    jcfg, tcfg = _configs(mode, head_dim=hd, n_heads=h, n_kv_heads=kv,
                          window=window)
    q, k, v = _qkv(name, s, hd, h, kv)
    pos = np.arange(s)
    want = np.asarray(jax.jit(lambda q, k, v, p: JL.attend_blocked(
        q, k, v, p, p, jcfg, "serve", causal=causal))(q, k, v, pos))
    tpos = torch.from_numpy(pos)
    got = TL.attend_blocked(*map(torch.from_numpy, (q, k, v)), tpos, tpos,
                            tcfg, "serve", causal=causal).numpy()
    assert got.shape == want.shape == (2, s, h, hd)
    assert np.isfinite(got).all()
    scale = max(np.abs(want).max(), 1.0)
    rows = np.abs(got - want).max(-1)
    if mode == "exact":
        assert rows.max() <= EXACT_TOL * scale
    elif hd == 16:
        assert rows.max() <= SOLE_TOL * scale
    else:
        assert (rows <= SOLE_TOL * scale).mean() >= SHARE


def test_window_band_sees_only_its_keys():
    """With a window the band branch scans a slice of K/V: keys outside
    every query's window change nothing, as in the dense path."""
    _, tcfg = _configs("sole", window=48)
    q, k, v = map(torch.from_numpy, _qkv("band", 200, 16, 4, 2))
    pos = torch.arange(200)
    out = TL.attend_blocked(q, k, v, pos, pos, tcfg, "serve")
    k2, v2 = k.clone(), v.clone()
    k2[:, :100] = 7.0             # the keys before query 100 - 48 + 1 = 53
    v2[:, :100] = -7.0            # ... are outside rows 148.. windows
    out2 = TL.attend_blocked(q, k2, v2, pos, pos, tcfg, "serve")
    assert torch.equal(out[:, 148:], out2[:, 148:])
    dense = TL.attend_dense(q, k, v, pos, pos,
                            dataclasses.replace(tcfg, softmax_mode="exact"),
                            "serve")
    blocked = TL.attend_blocked(q, k, v, pos, pos, dataclasses.replace(
        tcfg, softmax_mode="exact"), "serve")
    assert (blocked - dense).abs().max() <= EXACT_TOL * 4


@pytest.mark.parametrize("mode", ["exact", "sole"])
def test_models_under_blocked_attention_match_reference(mode):
    jcfg, tcfg = _configs(mode, attn_impl="blocked")
    params, _ = japi.init_params(0, jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, params), tcfg, "cpu")
    tokens = np.random.default_rng(7).integers(
        0, tcfg.vocab_size, (2, 72)).astype(np.int32)
    want = np.asarray(jax.jit(lambda p, t: japi.forward(
        p, {"tokens": t}, jcfg, "serve"))(params, jnp.asarray(tokens)))
    got = api.forward(tparams, {"tokens": torch.from_numpy(tokens)}, tcfg,
                      "serve").numpy()
    model = japi.get_model(jcfg)
    jlogits, jcache = jax.jit(lambda p, t: model.prefill(
        p, t, jcfg, 96))(params, jnp.asarray(tokens))
    tlogits, tcache = api.prefill(tparams, torch.from_numpy(tokens), tcfg,
                                  96)
    rows = np.abs(got - want).max(-1).ravel()
    prow = np.abs(tlogits.numpy() - np.asarray(jlogits)).max(-1).ravel()
    if mode == "exact":
        assert rows.max() <= MODEL_TOL and prow.max() <= MODEL_TOL
        for key in ("k", "v"):
            np.testing.assert_allclose(tcache[key].numpy(),
                                       np.asarray(jcache[key]),
                                       atol=MODEL_TOL)
    else:
        assert (rows <= MODEL_TOL).mean() >= SHARE, rows
        assert (prow <= MODEL_TOL).mean() >= SHARE, prow
    np.testing.assert_array_equal(tcache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))


def test_auto_picks_blocked_from_8192_tokens():
    _, tcfg = _configs("sole")
    assert TL.attn_impl(tcfg, 8191) == "dense"
    assert TL.attn_impl(tcfg, 8192) == "blocked"
    assert TL.attn_impl(dataclasses.replace(tcfg, attn_impl="dense"),
                        9000) == "dense"


def test_blocked_prefill_with_left_padding_attends_dense(monkeypatch):
    """Left-padded lanes carry per-lane positions: the prefill attends
    dense there, as the reference does, and blocked without padding."""
    _, tcfg = _configs("exact", attn_impl="blocked")
    params = api.init_params(0, tcfg, "cpu")
    calls = []
    orig = TL.attend_blocked

    def counted(*a, **k):
        calls.append(1)
        return orig(*a, **k)
    monkeypatch.setattr(TL, "attend_blocked", counted)
    tokens = torch.zeros((2, 8), dtype=torch.int32)
    api.prefill(params, tokens, tcfg, 16,
                n_pad=torch.tensor([0, 3], dtype=torch.int32))
    assert calls == []
    api.prefill(params, tokens, tcfg, 16)
    assert len(calls) == tcfg.n_layers
