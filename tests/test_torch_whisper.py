"""whisper (``repro_torch.models.whisper``) against the JAX package's
``repro.models.whisper`` on the CPU: the float32 smoke config (2 + 2
layers, d 64, 4 heads, cross_len 32), the JAX ``init_params`` weights
carried through ``params_from_jax`` and the same numpy-seeded inputs. JAX
functions run jitted, as the engines run them; JAX's paged attention runs
its Pallas kernel in interpret mode (``backend="pallas"``), as its own
tests run it on the CPU.

Tolerances, stated per check:

* the sinusoid rows to ``pos * 2**-23``: XLA's and torch's float32 ``pow``
  round an ulp apart on ~30% of the frequencies and the angle carries
  that ulp times the position;
* exact mode: encoder states and cross K/V to 1e-5 (unit-scale rows,
  float32 sums in another order), logits to 1e-4;
* SOLE mode: the engine tests' bar, at least 95% of paged calls within
  1e-4 of the logits; single attention and encoder calls to 1e-5, which
  holds only with every E2Softmax code equal (a code apart moves a
  probability by a factor of two).
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
from repro.models import whisper as JW
from repro_torch.configs.base import get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import api
from repro_torch.models import layers as TL
from repro_torch.models import whisper as TW

EXACT = dict(softmax_mode="exact", norm_mode="exact", logit_int8=False)
STATE_ATOL = 1e-5
LOGIT_ATOL = 1e-4
SOLE_CALL_AGREEMENT = 0.95
MODES = ("exact", "sole")
BS, NB, N_BLOCKS = 4, 8, 24          # page size, table width, pool pages


def _cfgs(mode="exact", **change):
    kw = dict(EXACT if mode == "exact" else {}, **change)
    return (dataclasses.replace(jax_config("whisper_small").smoke(), **kw),
            dataclasses.replace(get_config("whisper_small").smoke(), **kw))


@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg = _cfgs()
    jp = japi.init_params(0, jcfg)[0]
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")


def _frames(rng, b, s, d=64, scale=0.5):
    return (rng.standard_normal((b, s, d)) * scale).astype(np.float32)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: tree}


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=0,
                               atol=atol)


# -- weights -------------------------------------------------------------------


def test_weight_round_trip(weights):
    """Every leaf of the JAX tree arrives bit for bit (float32 smoke); in
    bf16 the norms (the decoder's ``ln_x`` and ``enc_norm`` too) stay
    float32 and the projections take the reference's per-use cast."""
    jp, tp = weights
    jf, tf = _flat(jax.tree.map(np.asarray, jp)), _flat(tp)
    assert set(jf) == set(tf)
    assert {k[0] for k in jf} == {"embed", "enc_layers", "enc_norm",
                                  "dec_layers", "final_norm"}
    for k, a in jf.items():
        assert np.array_equal(tf[k].numpy(), a), k
    bcfg = dataclasses.replace(_cfgs()[1], dtype="bfloat16")
    tb = _flat(params_from_jax(jax.tree.map(np.asarray, jp), bcfg, "cpu"))
    for k, t in tb.items():
        norm = any(n in k for n in ("ln1", "ln2", "ln_x", "enc_norm",
                                    "final_norm"))
        assert t.dtype == (torch.float32 if norm else torch.bfloat16), k
        want = jnp.asarray(jf[k]).astype(jnp.float32 if norm
                                          else jnp.bfloat16)
        assert np.array_equal(t.float().numpy(),
                              np.asarray(want.astype(jnp.float32))), k


# -- positions -------------------------------------------------------------------


@pytest.mark.parametrize("s,d", [(32, 64), (448, 768), (1500, 768)])
def test_sin_rows_match_reference(s, d):
    """``_sin_pos`` against the jitted reference: row ``pos`` within
    ``pos * 2**-23``; the per-lane rows of the paged path are the same
    function (bitwise equal to ``_sin_pos``'s rows)."""
    want = np.asarray(jax.jit(JW._sin_pos, static_argnums=(0, 1))(s, d))
    got = TW._sin_pos(s, d, "cpu").numpy()
    tol = np.maximum(np.arange(s), 1)[:, None] * 2.0 ** -23
    assert (np.abs(got - want) <= tol).all()
    pos = torch.tensor([[0, 5, s - 1], [7, s // 2, 1]])
    rows = TW.sin_rows(pos, d).numpy()
    assert np.array_equal(rows, got[pos.numpy()])


# -- cross-attention -------------------------------------------------------------


def test_cross_kv_matches_reference(weights):
    jp, tp = weights
    jcfg, tcfg = _cfgs()
    enc = _frames(np.random.default_rng(1), 2, 32)
    jx = jax.tree.map(lambda a: a[1], jp["dec_layers"]["xattn"])
    tx = {k: v[1] for k, v in tp["dec_layers"]["xattn"].items()}
    jk, jv = jax.jit(lambda p, e: JL.cross_kv(p, e, jcfg))(jx,
                                                           jnp.asarray(enc))
    tk, tv = TL.cross_kv(tx, torch.tensor(enc), tcfg)
    _close(tk, jk, STATE_ATOL)
    _close(tv, jv, STATE_ATOL)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("per_lane", [True, False])
def test_cross_attention_matches_reference(weights, mode, per_lane):
    """Queries (2, 5) against (2, 32) encoder rows: per-lane 2-D ``k_pos``
    (lane 0 valid on 20 rows, the tail at 2**30) or the shared 1-D one;
    the padded tail's K/V never reach the output."""
    jp, tp = weights
    jcfg, tcfg = _cfgs(mode)
    rng = np.random.default_rng(2)
    x = _frames(rng, 2, 5)
    k = (rng.standard_normal((2, 32, 4, 16))).astype(np.float32)
    v = (rng.standard_normal((2, 32, 4, 16))).astype(np.float32)
    valid = np.array([20, 32]) if per_lane else np.array([32])
    cols = np.arange(32)[None]
    kpos = np.where(cols < valid[:, None], cols, 2 ** 30).astype(np.int32)
    if not per_lane:
        kpos = kpos[0]
    jx = jax.tree.map(lambda a: a[0], jp["dec_layers"]["xattn"])
    tx = {n: t[0] for n, t in tp["dec_layers"]["xattn"].items()}
    want = jax.jit(lambda p, x, k, v, kp: JL.apply_cross_attention(
        p, x, (k, v), jcfg, "serve", k_pos=kp))(
            jx, *map(jnp.asarray, (x, k, v, kpos)))
    got = TL.apply_cross_attention(tx, torch.tensor(x), (torch.tensor(k),
                                                         torch.tensor(v)),
                                   tcfg, "serve", k_pos=torch.tensor(kpos))
    _close(got, want, STATE_ATOL)
    if per_lane:
        k2, v2 = k.copy(), v.copy()
        k2[0, 20:] = 50.0
        v2[0, 20:] = -50.0
        again = TL.apply_cross_attention(
            tx, torch.tensor(x), (torch.tensor(k2), torch.tensor(v2)), tcfg,
            "serve", k_pos=torch.tensor(kpos))
        assert torch.equal(again, got)


# -- whole sequences ---------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
def test_encode_matches_reference(weights, mode):
    """Non-causal encoder over (2, 24) frames (a SOLE norm calibrates over
    all 48 rows), then the encoder norm."""
    jp, tp = weights
    jcfg, tcfg = _cfgs(mode)
    fr = _frames(np.random.default_rng(3), 2, 24)
    want = jax.jit(lambda p, f: JW.encode(p, f, jcfg, "serve"))(
        jp, jnp.asarray(fr))
    _close(TW.encode(tp, torch.tensor(fr), tcfg, "serve"), want, STATE_ATOL)


@pytest.mark.parametrize("mode", MODES)
def test_forward_matches_reference(weights, mode):
    jp, tp = weights
    jcfg, tcfg = _cfgs(mode)
    rng = np.random.default_rng(4)
    fr = _frames(rng, 2, 24)
    toks = rng.integers(0, tcfg.vocab_size, (2, 12)).astype(np.int32)
    want = jax.jit(lambda p, b: japi.forward(p, b, jcfg))(
        jp, {"frames": jnp.asarray(fr), "tokens": jnp.asarray(toks)})
    got = api.forward(tp, {"frames": torch.tensor(fr),
                           "tokens": torch.tensor(toks)}, tcfg)
    assert got.shape == (2, 12, tcfg.padded_vocab)
    _close(got, want, LOGIT_ATOL)


def test_prefill_decode_match_forward(weights):
    """The dense-cache oracle, the encdec case of ``tests/test_parity.py``
    (b 2, s 16 + 4 tokens, 24 frames): prefill + decode steps against the
    port's ``forward`` and against the JAX prefill/decode logits (1e-4;
    the reference's own bar against its forward is 2e-3)."""
    jp, tp = weights
    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(5)
    b, s, extra = 2, 16, 4
    fr = _frames(rng, b, 24, scale=0.1)
    toks = rng.integers(0, tcfg.vocab_size, (b, s + extra)).astype(np.int32)
    full = api.forward(tp, {"frames": torch.tensor(fr),
                            "tokens": torch.tensor(toks)}, tcfg).numpy()
    lg, cache = api.prefill(tp, {"frames": torch.tensor(fr),
                                 "tokens": torch.tensor(toks[:, :s])},
                            tcfg, s + extra)
    jlg, jcache = jax.jit(lambda p, bt: JW.prefill(p, bt, jcfg, s + extra))(
        jp, {"frames": jnp.asarray(fr), "tokens": jnp.asarray(toks[:, :s])})
    _close(lg[:, 0], full[:, s - 1], LOGIT_ATOL)
    _close(lg, jlg, LOGIT_ATOL)
    _close(cache["cross_k"], jcache["cross_k"], STATE_ATOL)
    assert np.array_equal(cache["cross_pos"].numpy(),
                          np.asarray(jcache["cross_pos"]))
    jstep = jax.jit(lambda p, c, t, pos: JW.decode_step(p, c, t, pos, jcfg))
    for i in range(extra):
        lg, cache = api.decode_step(tp, cache, torch.tensor(toks[:, s + i]),
                                    s + i, tcfg)
        jlg, jcache = jstep(jp, jcache, jnp.asarray(toks[:, s + i]),
                            jnp.asarray(s + i, jnp.int32))
        _close(lg, full[:, s + i], LOGIT_ATOL)
        _close(lg, jlg, LOGIT_ATOL)


# -- paged serving ---------------------------------------------------------------


def _pool(cfg, dtype):
    shape = (cfg.n_layers, N_BLOCKS, BS, cfg.n_kv_heads, cfg.head_dim)
    return np.zeros(shape, dtype)


def _tables():
    """Lane 0: cross pages 1-8, self pages 17-20; lane 1: cross 9-16, self
    21-23 (the table's tail on the null page)."""
    cross = np.array([np.arange(1, 9), np.arange(9, 17)], np.int32)
    tables = np.zeros((2, NB), np.int32)
    tables[0, :4] = np.arange(17, 21)
    tables[1, :3] = np.arange(21, 24)
    return cross, tables


@pytest.mark.parametrize("kv", ["auto", "int8"])
def test_encode_paged_pages_match_reference(weights, kv):
    """Every decoder layer's cross K/V in the request's pages: lane 0
    from 20 frames (rows 20-31 the zero-padded tail's K/V), lane 1 from
    40 frames cut to cross_len; bf16-free float32 pages within 1e-5, int8
    codes at most one apart and 99% equal; no other page is written."""
    jp, tp = weights
    jcfg, tcfg = _cfgs(kv_cache_dtype=kv)
    dt = np.int8 if kv == "int8" else np.float32
    rng = np.random.default_rng(6)
    cross, _ = _tables()
    jst = {"k": jnp.asarray(_pool(tcfg, dt)), "v": jnp.asarray(_pool(tcfg,
                                                                     dt))}
    tst = {"k": torch.tensor(_pool(tcfg, dt)),
           "v": torch.tensor(_pool(tcfg, dt))}
    enc = jax.jit(lambda p, f, c, s: JW.encode_paged(p, f, c, s, jcfg))
    for lane, n in ((0, 20), (1, 40)):
        fr = _frames(rng, 1, n)
        row = cross[lane:lane + 1]
        jst = enc(jp, jnp.asarray(fr), jnp.asarray(row), jst)
        tst = api.encode_paged(tp, torch.tensor(fr), torch.tensor(row), tst,
                               tcfg)
    for key in ("k", "v"):
        got, want = tst[key].numpy(), np.asarray(jst[key])
        assert not got[:, 17:].any() and not got[:, 0].any()
        if kv == "int8":
            diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
            assert diff.max() <= 1 and (diff == 0).mean() >= 0.99
        else:
            _close(got, want, STATE_ATOL)


def _paged_trace(jp, tp, jcfg, tcfg, rng):
    """Encode two lanes, prefill each (chunks of 8: lane 0 six real
    tokens, lane 1 eight), a two-lane decode step, then a greedy four-step
    horizon, on both sides. Returns the per-call logits error and the
    horizon's tokens (port, JAX)."""
    cross, tables = _tables()
    valid = np.array([20, 32], np.int32)
    jst = {"k": jnp.asarray(_pool(tcfg, np.float32)),
           "v": jnp.asarray(_pool(tcfg, np.float32))}
    tst = {"k": torch.tensor(_pool(tcfg, np.float32)),
           "v": torch.tensor(_pool(tcfg, np.float32))}
    enc = jax.jit(lambda p, f, c, s: JW.encode_paged(p, f, c, s, jcfg))
    for lane, n in ((0, 20), (1, 32)):
        fr = _frames(rng, 1, n)
        row = cross[lane:lane + 1]
        jst = enc(jp, jnp.asarray(fr), jnp.asarray(row), jst)
        tst = api.encode_paged(tp, torch.tensor(fr), torch.tensor(row), tst,
                               tcfg)

    def refs(lanes, to):
        return {"tables": to(tables[lanes]), "cross": to(cross[lanes]),
                "cross_valid": to(valid[lanes])}
    jref = lambda lanes: refs(lanes, jnp.asarray)          # noqa: E731
    tref = lambda lanes: refs(lanes, torch.tensor)          # noqa: E731
    jpre = jax.jit(lambda p, t, qs, nv, r, s: JW.prefill_paged(
        p, t, qs, nv, r, s, jcfg, backend="pallas"))
    jdec = jax.jit(lambda p, t, pos, r, s: JW.decode_step_paged(
        p, t, pos, r, s, jcfg, backend="pallas"))
    errs = []
    prompts = rng.integers(0, tcfg.vocab_size, (2, 8)).astype(np.int32)
    for lane, real in ((0, 6), (1, 8)):
        args = (prompts[lane:lane + 1], np.array([0], np.int32),
                np.array([real], np.int32))
        jl, jst = jpre(jp, *map(jnp.asarray, args), jref([lane]), jst)
        tl, tst = api.prefill_paged(tp, *map(torch.tensor, args),
                                    tref([lane]), tst, tcfg)
        errs.append(np.abs(tl.numpy()[:, :real]
                           - np.asarray(jl)[:, :real]).max())
    tok = np.array([7, 11], np.int32)
    pos = np.array([6, 8], np.int32)
    jl, jst = jdec(jp, jnp.asarray(tok), jnp.asarray(pos), jref([0, 1]), jst)
    tl, tst = api.decode_step_paged(tp, torch.tensor(tok), torch.tensor(pos),
                                    tref([0, 1]), tst, tcfg)
    errs.append(np.abs(tl.numpy() - np.asarray(jl)).max())
    zeros = np.zeros(2, np.int32)
    eos = np.full((2, 1), -1, np.int32)
    jh = jax.jit(lambda p, t, pos, r, s: JW.decode_horizon_paged(
        p, t, pos, r, s, jnp.zeros(2, jnp.float32), jnp.asarray(zeros),
        jnp.asarray(zeros.astype(np.uint32)), jnp.asarray(zeros),
        jnp.asarray(eos), jcfg, num_steps=4, use_top_k=False,
        stochastic=False, backend="pallas"))
    jtoks, _, _ = jh(jp, jnp.asarray(tok + 1), jnp.asarray(pos + 1),
                     jref([0, 1]), jst)
    ttoks, _, _ = api.decode_horizon_paged(
        tp, torch.tensor(tok + 1), torch.tensor(pos + 1), tref([0, 1]), tst,
        None, None, None, None, torch.tensor(eos), tcfg, num_steps=4,
        use_top_k=False, stochastic=False)
    return errs, ttoks.numpy(), np.asarray(jtoks)


@pytest.mark.parametrize("mode", MODES)
def test_paged_calls_match_reference(weights, mode):
    """``encode_paged``, ``prefill_paged`` (a padded final chunk),
    ``decode_step_paged`` and ``decode_horizon_paged`` with ragged
    ``cross_valid``: the logits of every call within 1e-4 (SOLE: at least
    95% of calls), the horizon's greedy tokens equal."""
    jp, tp = weights
    jcfg, tcfg = _cfgs(mode)
    errs, got, want = _paged_trace(jp, tp, jcfg, tcfg,
                                   np.random.default_rng(7))
    ok = np.mean([e <= LOGIT_ATOL for e in errs])
    assert ok >= (1.0 if mode == "exact" else SOLE_CALL_AGREEMENT), errs
    assert np.array_equal(got, want)


def test_paged_matches_dense_oracle(weights):
    """The paged path against the port's own dense-cache oracle on one
    request of 20 frames (the cross tail masked on both): prefill logits
    of the last prompt position and three decode steps within 1e-4."""
    _, tp = weights
    _, tcfg = _cfgs()
    rng = np.random.default_rng(8)
    fr = _frames(rng, 1, 20, scale=0.1)
    prompt = rng.integers(0, tcfg.vocab_size, (1, 6)).astype(np.int32)
    lg, cache = api.prefill(tp, {"frames": torch.tensor(fr),
                                 "tokens": torch.tensor(prompt)}, tcfg, 12)
    cross, tables = _tables()
    refs = {"tables": torch.tensor(tables[:1]),
            "cross": torch.tensor(cross[:1]),
            "cross_valid": torch.tensor([20], dtype=torch.int32)}
    st = {"k": torch.tensor(_pool(tcfg, np.float32)),
          "v": torch.tensor(_pool(tcfg, np.float32))}
    st = api.encode_paged(tp, torch.tensor(fr), refs["cross"], st, tcfg)
    plg, st = api.prefill_paged(tp, torch.tensor(prompt),
                                torch.tensor([0], dtype=torch.int32),
                                torch.tensor([6], dtype=torch.int32), refs,
                                st, tcfg)
    _close(plg[:, -1], lg[:, 0], LOGIT_ATOL)
    tok = int(lg[0, 0, :tcfg.vocab_size].argmax())
    for i in range(3):
        dlg, cache = api.decode_step(tp, cache, torch.tensor([tok]), 6 + i,
                                     tcfg)
        plg, st = api.decode_step_paged(
            tp, torch.tensor([tok], dtype=torch.int32),
            torch.tensor([6 + i], dtype=torch.int32), refs, st, tcfg)
        _close(plg, dlg, LOGIT_ATOL)
        tok = int(dlg[0, :tcfg.vocab_size].argmax())
