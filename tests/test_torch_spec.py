"""Speculative decoding in the port on the CPU against the JAX package:
the verify dispatch, the drafters, the K controller and the spec engine.

The same smoke weights (qwen2_0_5b, exact mode unless a test says
otherwise) go through the JAX ``PagedEngine`` with its Pallas kernels in
interpret mode and through the port's ``PagedEngine`` on the CPU:

* ``verify_paged``: the (B, C) verify forward's logits agree with JAX's
  to ``VERIFY_ATOL`` in exact mode (float32 sums in other orders), and in
  SOLE mode on at least ``SOLE_ROW_AGREEMENT`` of the rows (a code can
  flip on a one-ulp difference); the pinned draws and their eos mask are
  equal, and each draw equals the host ``Sampler``'s on the port's
  logits;
* the engine: tokens equal to the JAX spec engine's and to the port's
  plain engine, and every ``stats()`` counter both report (the spec
  counters included) equal to JAX's, for self-drafting at K 1, 2, 4 and
  8, an oracle, an anti-oracle and the n-gram drafter, under eos and stop
  events, preemption and COW-forked prefixes;
* at w8a8 in exact mode every projection is an exact int32 sum, so spec
  tokens equal plain ones.
"""
import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_serve_helpers import (EXACT, AntiOracleDrafter, OracleDrafter,
                                  as_requests, common_stats, jax_engine,
                                  smoke_pair, specs, torch_engine)
from repro.models import api as japi
from repro.serve import spec as jspec
from repro.serve.scheduler import Sequence as JaxSequence
from repro_torch.configs.base import QuantConfig, get_config
from repro_torch.launch import serve as launcher
from repro_torch.models import api
from repro_torch.serve import spec as tspec
from repro_torch.serve.sampling import Sampler
from repro_torch.serve.scheduler import Sequence

VERIFY_ATOL = 1e-4
SOLE_ROW_AGREEMENT = 0.9
SPEC_KEYS = ("spec_dispatches", "spec_proposed_tokens",
             "spec_accepted_tokens", "spec_fallback_steps",
             "acceptance_rate", "accepted_tokens_per_target_dispatch")


@pytest.fixture(scope="module")
def exact_lm():
    return smoke_pair()


def _mixed(vocab, rng):
    """Greedy and stochastic lanes in one trace (the reference's mix)."""
    return (specs(vocab, 2, rng) +
            specs(vocab, 2, rng, temperature=0.9, top_k=6, new=7, seed=5))


def _spec_run(pair, req_specs, jdrafter, tdrafter, *, max_k, plain=None,
              **kw):
    """The trace through the JAX and the port spec engines and, unless
    ``plain`` is given, the port's plain engine (decode horizon 8).
    Returns (jax outs, port outs, plain outs, jax stats, port stats)."""
    jreqs, treqs = as_requests(req_specs)
    ctrl = {k: kw.pop(k) for k in ("ema_alpha", "demote_below",
                                   "promote_above", "retry_after")
            if k in kw}
    jeng = jax_engine(pair, spec_config=jspec.SpecConfig(
        jdrafter, max_k=max_k, **ctrl), **kw)
    teng = torch_engine(pair, spec_config=tspec.SpecConfig(
        tdrafter, max_k=max_k, **ctrl), **kw)
    jout, tout = jeng.generate(jreqs), teng.generate(treqs)
    teng.cache.check_refcounts()
    if plain is None:
        plain = torch_engine(pair, decode_horizon=8).generate(treqs)
    return jout, tout, plain, jeng.stats(), teng.stats()


def _check_parity(jout, tout, plain, jst, tst):
    assert tout == jout
    assert tout == plain
    js, ts = common_stats(jst, tst)
    assert set(SPEC_KEYS) <= set(ts)
    assert ts == js
    assert tst["blocks_in_use"] == 0


# -- the verify dispatch --------------------------------------------------------


def _verify_inputs(cfg, seed=0):
    """A random pool, page tables and a (B=4, C=5) verify batch: a full
    lane, a ragged one (n_valid 3), a one-token one and a null lane."""
    rng = np.random.default_rng(seed)
    nb, bs, c = 40, 8, 5
    shape = (cfg.n_layers, nb, bs, cfg.n_kv_heads, cfg.head_dim)
    pools = {k: (rng.standard_normal(shape) * 0.5).astype(np.float32)
             for k in ("k", "v")}
    q_start = np.array([13, 20, 6, 0], np.int32)
    n_valid = np.array([5, 3, 1, 1], np.int32)
    tables = np.zeros((4, 8), np.int32)
    pages = rng.permutation(np.arange(1, nb))
    for i in range(3):
        used = -(-int(q_start[i] + n_valid[i]) // bs)
        tables[i, :used] = pages[8 * i:8 * i + used]
    tokens = rng.integers(0, cfg.vocab_size, (4, c)).astype(np.int32)
    tokens[np.arange(c)[None] >= n_valid[:, None]] = 0
    tokens[3] = 0
    lanes = dict(temperature=np.array([0.0, 0.9, 0.0, 0.0], np.float32),
                 top_k=np.array([0, 6, 0, 0], np.int32),
                 seed=np.array([0, 5, 0, 0], np.uint32),
                 counter=np.array([3, 7, 1, 0], np.int32))
    return pools, tokens, q_start, n_valid, tables, lanes


def _torch_verify(pair, pools, tokens, q_start, n_valid, tables, lanes, eos):
    t = torch.from_numpy
    state = {k: t(v.copy()) for k, v in pools.items()}
    refs = {"tables": t(tables)}
    logits, _ = api.prefill_paged(pair.tparams, t(tokens), t(q_start),
                                  t(n_valid), refs,
                                  {k: t(v.copy()) for k, v in pools.items()},
                                  pair.tcfg)
    pinned, done, state = api.verify_paged(
        pair.tparams, t(tokens), t(q_start), t(n_valid), refs, state,
        t(lanes["temperature"]), t(lanes["top_k"].astype(np.int64)),
        t(lanes["seed"].astype(np.int64)),
        t(lanes["counter"].astype(np.int64)), t(eos), pair.tcfg)
    return (logits.numpy(), pinned.numpy(), done.numpy(),
            {k: v.numpy() for k, v in state.items()})


def _jax_verify(pair, pools, tokens, q_start, n_valid, tables, lanes, eos):
    j = jnp.asarray
    refs = {"tables": j(tables)}
    logits, _ = japi.prefill_paged(
        pair.jparams, j(tokens), j(q_start), j(n_valid), refs,
        {k: j(v) for k, v in pools.items()}, pair.jcfg, backend="pallas")
    pinned, done, state = japi.verify_paged(
        pair.jparams, j(tokens), j(q_start), j(n_valid), refs,
        {k: j(v) for k, v in pools.items()}, j(lanes["temperature"]),
        j(lanes["top_k"]), j(lanes["seed"]), j(lanes["counter"]), j(eos),
        pair.jcfg, backend="pallas")
    return (np.asarray(logits), np.asarray(pinned), np.asarray(done),
            {k: np.asarray(v) for k, v in state.items()})


@pytest.mark.parametrize("mode", ["exact", "sole"])
def test_verify_matches_jax(mode, exact_lm):
    pair = exact_lm if mode == "exact" else smoke_pair(modes={})
    args = _verify_inputs(pair.tcfg)
    none = np.full((4, 1), -1, np.int32)
    first = _torch_verify(pair, *args, none)[1]
    # eos ids the lanes really draw: lane 0 at slot 2, lane 2 at slot 0
    eos = np.full((4, 2), -1, np.int32)
    eos[0, 0], eos[2, 1] = first[0, 2], first[2, 0]
    tl, tp, td, tstate = _torch_verify(pair, *args, eos)
    jl, jp, jd, jstate = _jax_verify(pair, *args, eos)
    vocab = pair.tcfg.vocab_size
    err = np.abs(tl - jl)[..., :vocab].max(-1)         # (B, C) per row
    if mode == "exact":
        assert err.max() <= VERIFY_ATOL, err
    else:
        assert (err <= VERIFY_ATOL).mean() >= SOLE_ROW_AGREEMENT, err
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(td, jd)
    assert td[0, 2] and td[2, 0] and td.sum() >= 2
    # each pinned draw is the host Sampler's draw on the port's logits
    lanes = args[-1]
    for i in range(4):
        s = Sampler(float(lanes["temperature"][i]), int(lanes["top_k"][i]),
                    int(lanes["seed"][i]), vocab)
        for j in range(tl.shape[1]):
            assert tp[i, j] == s.draw(tl[i, j], int(lanes["counter"][i]) + j)
    # the written K/V: the lanes' pages and the null page, as JAX writes them
    for k in ("k", "v"):
        np.testing.assert_allclose(tstate[k], jstate[k], atol=VERIFY_ATOL)


def test_verify_slots_match_decode_steps(exact_lm):
    """The C > 1 route against the C = 1 route for the same query rows: a
    (1, 4) verify at position p against four decode steps from p, feeding
    the same tokens: the same greedy tokens, logits within 1e-5."""
    pair = exact_lm
    eng = torch_engine(pair)
    rng = np.random.default_rng(3)
    seq = eng.submit(as_requests(specs(pair.tcfg.vocab_size, 1, rng,
                                       plen=13, new=16))[1][0])
    while len(seq.out) < 3:
        eng.step()
    k = 3
    pos = seq.prompt_len + len(seq.out) - 1
    eng._apply_copies(eng.sched.ensure_tokens(seq, pos, pos + k + 1))
    refs = eng._refs([seq])
    pools = {n: p.clone() for n, p in eng.cache.pools.items()}
    toks, dec, cur = [seq.out[-1]], [], seq.out[-1]
    dp = {n: p.clone() for n, p in pools.items()}
    for i in range(k + 1):
        lg, dp = api.decode_step_paged(
            pair.tparams, torch.tensor([cur], dtype=torch.int32),
            torch.tensor([pos + i], dtype=torch.int32), refs, dp, pair.tcfg)
        dec.append(lg[0].numpy())
        cur = int(np.argmax(dec[-1][:pair.tcfg.vocab_size]))
        toks.append(cur)
    vl, _ = api.prefill_paged(
        pair.tparams, torch.tensor([toks[:k + 1]], dtype=torch.int32),
        torch.tensor([pos], dtype=torch.int32),
        torch.tensor([k + 1], dtype=torch.int32), refs, pools, pair.tcfg)
    vl = vl[0].numpy()
    for i in range(k + 1):
        assert int(np.argmax(vl[i][:pair.tcfg.vocab_size])) == toks[i + 1]
        assert np.abs(vl[i] - dec[i]).max() <= 1e-5, i
    eng.cancel(seq)
    eng.cache.check_refcounts()


# -- drafters -------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_ngram_proposals_match_jax(seed):
    rng = np.random.default_rng(seed)
    jd, td = jspec.NGramDrafter(), tspec.NGramDrafter(max_ngram=3)
    lanes = []
    for n in (1, 2, 5, 17, 40, 64):
        ctx = rng.integers(0, 6, n).astype(np.int32)
        cut = int(rng.integers(0, n + 1))
        lanes.append(types.SimpleNamespace(prompt=ctx[:cut],
                                           out=[int(t) for t in ctx[cut:]]))
        for k in range(6):
            assert td._match(ctx, k) == jd._match(ctx, k)
    ks = [int(k) for k in rng.integers(0, 6, len(lanes))]
    assert td.propose(lanes, ks) == jd.propose(lanes, ks)
    assert any(td.propose(lanes, ks))


def test_ngram_match_semantics():
    """The reference's prompt-lookup rules: the longest suffix wins, ties
    go to the most recent occurrence, proposals clip to k."""
    d = tspec.NGramDrafter(max_ngram=3, min_ngram=1)
    ctx = np.array([1, 7, 8, 9, 4, 5, 7, 8, 9], np.int32)
    assert d._match(ctx, 2) == [4, 5]
    assert d._match(ctx, 4) == [4, 5, 7, 8]
    ctx = np.array([1, 2, 9, 1, 2, 5, 1, 2], np.int32)
    assert d._match(ctx, 1) == [5]
    assert d._match(np.array([1, 2, 3, 4], np.int32), 2) == []
    assert d._match(ctx, 0) == []
    with pytest.raises(ValueError):
        tspec.NGramDrafter(max_ngram=1, min_ngram=2)


def test_draft_model_proposals_match_jax(exact_lm):
    """The draft model's proposals at each lane's counters, greedy and
    stochastic lanes, against the JAX drafter on the same weights."""
    pair = exact_lm
    rng = np.random.default_rng(9)
    lanes = []
    for n, out, temp in ((5, 3, 0.0), (30, 0, 0.9), (70, 9, 0.0)):
        s = Sampler(temp, 6 if temp else 0, 11, pair.tcfg.vocab_size)
        lanes.append(types.SimpleNamespace(
            prompt=rng.integers(0, pair.tcfg.vocab_size, n).astype(np.int32),
            out=[int(t) for t in rng.integers(0, pair.tcfg.vocab_size, out)],
            sampler=s))
    ks = [4, 2, 3]
    jd = jspec.DraftModelDrafter(pair.jcfg, pair.jparams, window=64)
    td = tspec.DraftModelDrafter(pair.tcfg, pair.tparams, window=64)
    got = td.propose(lanes, ks)
    assert got == jd.propose(lanes, ks)
    assert [len(d) for d in got] == ks
    assert td.forwards == max(ks)
    assert [s.sampler.draws for s in lanes] == [0, 0, 0]   # untouched


# -- the spec engine --------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_spec_engine_self_draft_matches_jax(exact_lm, k):
    pair = exact_lm
    reqs = _mixed(pair.tcfg.vocab_size, np.random.default_rng(41))
    res = _spec_run(
        pair, reqs, jspec.DraftModelDrafter(pair.jcfg, pair.jparams),
        tspec.DraftModelDrafter(pair.tcfg, pair.tparams), max_k=k)
    _check_parity(*res)
    assert res[4]["spec_dispatches"] > 0
    assert res[4]["acceptance_rate"] > 0.9


@pytest.mark.parametrize("kind", ["oracle", "anti-oracle"])
def test_spec_engine_oracles_match_jax(exact_lm, kind):
    pair = exact_lm
    vocab = pair.tcfg.vocab_size
    reqs = (specs(vocab, 4, np.random.default_rng(42), new=16)
            if kind == "oracle" else _mixed(vocab, np.random.default_rng(43)))
    plain = torch_engine(pair, decode_horizon=8)
    ref = plain.generate(as_requests(reqs)[1])
    outs = dict(enumerate(ref))
    drafter = (OracleDrafter(outs) if kind == "oracle"
               else AntiOracleDrafter(outs, vocab))
    res = _spec_run(pair, reqs, drafter, drafter, plain=ref,
                    max_k=8 if kind == "oracle" else 4,
                    retry_after=100 if kind == "anti-oracle" else 8)
    _check_parity(*res)
    st = res[4]
    if kind == "oracle":
        assert st["acceptance_rate"] == 1.0
        assert (st["accepted_tokens_per_target_dispatch"]
                > plain.stats()["tokens_per_dispatch"])
    else:
        assert st["acceptance_rate"] == 0.0
        assert st["truncated_tokens"] >= st["spec_proposed_tokens"]
        assert st["spec_fallback_steps"] > 0   # back on the decode horizon


def test_spec_engine_ngram_matches_jax():
    """A 32-token vocabulary with prompts that cover it: every generated
    token re-occurs in the context, so the drafter always proposes."""
    pair = smoke_pair(vocab_size=32)
    rng = np.random.default_rng(44)
    reqs = [dict(prompt=rng.permutation(32).astype(np.int32),
                 max_new_tokens=8) for _ in range(3)]
    res = _spec_run(pair, reqs, jspec.NGramDrafter(), tspec.NGramDrafter(),
                    max_k=4)
    _check_parity(*res)
    assert res[4]["spec_dispatches"] > 0


def test_spec_eos_mid_verify(exact_lm):
    pair = exact_lm
    vocab = pair.tcfg.vocab_size
    reqs = specs(vocab, 4, np.random.default_rng(45), new=12)
    ref = torch_engine(pair, decode_horizon=8).generate(as_requests(reqs)[1])
    eos_reqs = [dict(r, eos_ids=(o[len(o) // 2],)) for r, o in zip(reqs, ref)]
    drafter = OracleDrafter(dict(enumerate(ref)))
    res = _spec_run(pair, eos_reqs, drafter, drafter, max_k=8)
    _check_parity(*res)
    assert res[4]["finish_reasons"].get("eos", 0) == 4


def test_spec_stop_sequence_spanning_verify_boundary(exact_lm):
    """K = 4 all-accepted verifies emit stream indices 1..5, then 6..: a
    stop pair at (5, 6) completes one token into the second dispatch."""
    pair = exact_lm
    reqs = specs(pair.tcfg.vocab_size, 2, np.random.default_rng(46), new=10)
    ref = torch_engine(pair, decode_horizon=8).generate(as_requests(reqs)[1])
    stop_reqs = [dict(r, stop=((o[5], o[6]),)) for r, o in zip(reqs, ref)]
    drafter = OracleDrafter(dict(enumerate(ref)))
    res = _spec_run(pair, stop_reqs, drafter, drafter, max_k=4)
    _check_parity(*res)
    assert res[4]["finish_reasons"].get("stop", 0) == 2
    assert all(o == r[:7] for o, r in zip(res[1], ref))


def test_spec_parity_across_preemption(exact_lm):
    pair = exact_lm
    reqs = specs(pair.tcfg.vocab_size, 5, np.random.default_rng(47))
    ref = torch_engine(pair, decode_horizon=1).generate(as_requests(reqs)[1])
    res = _spec_run(pair, reqs,
                    jspec.DraftModelDrafter(pair.jcfg, pair.jparams),
                    tspec.DraftModelDrafter(pair.tcfg, pair.tparams),
                    max_k=4, plain=ref, num_blocks=8, watermark=0)
    _check_parity(*res)
    assert res[4]["preemptions"] > 0


def test_rejected_tails_reclaim_pages_on_cow_forked_lanes(exact_lm):
    """A lane forked off a live shared prefix (12-token prompt, 11 tokens
    matched, so its recompute writes into the shared partial page: a COW)
    runs wide always-rejected verifies; each rejected tail hands its
    pages back through ``truncate`` and the pool drains refcount-clean."""
    pair = exact_lm
    vocab = pair.tcfg.vocab_size
    shared = np.random.default_rng(48).integers(0, vocab, 12).astype(
        np.int32)
    req = dict(prompt=shared, max_new_tokens=10)
    jreqs, treqs = as_requests([req, req])
    ref = torch_engine(pair, decode_horizon=8).generate(treqs)
    drafter = AntiOracleDrafter(dict(enumerate(ref)), vocab)
    outs, stats = [], []
    for make, rs, cfg_mod in ((jax_engine, jreqs, jspec),
                              (torch_engine, treqs, tspec)):
        eng = make(pair, spec_config=cfg_mod.SpecConfig(
            drafter, max_k=8, demote_below=0.0))
        a = eng.submit(rs[0])
        while a.in_prefill:
            eng.step()
        b = eng.submit(rs[1])
        while eng.sched.has_work:
            eng.step()
        eng.cache.check_refcounts()
        outs.append([list(a.out), list(b.out)])
        stats.append(eng.stats())
    assert outs[1] == outs[0] == ref
    js, ts = common_stats(*stats)
    assert ts == js
    assert ts["cow_copies"] > 0 and ts["prefix_hit_tokens"] > 0
    assert ts["reclaimed_pages"] > 0 and ts["acceptance_rate"] == 0.0
    assert ts["blocks_in_use"] == 0


def test_spec_controller_k_trajectory(exact_lm):
    """The EMA controller on one feedback sequence (all rejected, the
    cool-down, the re-probe, all accepted, the budget cap): the port's K
    trajectory equals the reference scheduler's step for step."""
    pair = exact_lm
    teng, jeng = torch_engine(pair), jax_engine(pair)
    knobs = dict(max_k=8, ema_alpha=0.5, retry_after=3)
    traj = []
    for sched, seq_cls, mod in ((jeng.sched, JaxSequence, jspec),
                                (teng.sched, Sequence, tspec)):
        spec = mod.SpecConfig(mod.NGramDrafter(), **knobs)
        seq = seq_cls(0, np.zeros(4, np.int32), max_new_tokens=100)
        ks = [sched.spec_ks([seq], spec)]
        for accept in [False] * 12 + [None] * 3 + [True] * 12:
            if accept is None:
                ks.append(sched.spec_ks([seq], spec))
                continue
            n = max(seq.spec_k, 1)
            sched.spec_feedback(seq, n, n if accept else 0, spec)
            ks.append((seq.spec_k, round(seq.spec_ema, 12)))
        for n_out in (97, 99):
            seq.out = [0] * n_out
            ks.append(sched.spec_ks([seq], spec))
        traj.append(ks)
    assert traj[1] == traj[0]
    assert traj[1][0] == [8] and traj[1][-2:] == [[2], [0]]


def test_spec_engine_refuses_a_drafter_of_another_vocab(exact_lm):
    pair = exact_lm
    drafter = tspec.DraftModelDrafter(
        dataclasses.replace(pair.tcfg, vocab_size=64), pair.tparams)
    with pytest.raises(ValueError, match="shared tokenizer"):
        torch_engine(pair, spec_config=tspec.SpecConfig(drafter))
    assert "spec_dispatches" not in torch_engine(pair).stats()


# -- spec_config_from_flag --------------------------------------------------------


@pytest.mark.parametrize("flag", ["", "ngram", "draft", "draft:minitron_8b",
                                  "draft:qwen2_0_5b"])
def test_spec_config_from_flag_matches_jax(flag, exact_lm):
    pair = exact_lm
    got = tspec.spec_config_from_flag(flag, pair.tcfg, max_k=2, seed=3,
                                      smoke=True, device="cpu")
    want = jspec.spec_config_from_flag(flag, pair.jcfg, max_k=2, seed=3,
                                       smoke=True)
    if not flag:
        assert got is None and want is None
        return
    assert type(got.drafter).__name__ == type(want.drafter).__name__
    assert (got.max_k, got.ema_alpha, got.retry_after) == (
        want.max_k, want.ema_alpha, want.retry_after)
    if flag.startswith("draft"):
        assert got.drafter.cfg.name == want.drafter.cfg.name
        assert got.drafter.vocab_size == pair.tcfg.vocab_size
        # draft weights: the port's init_params(seed + 1)
        want_p = api.init_params(4, got.drafter.cfg, "cpu")
        assert torch.equal(got.drafter.params["embed"]["table"],
                           want_p["embed"]["table"])


@pytest.mark.parametrize("flag,match", [
    ("draft:minitron_8b", "draft vocab 256000 != target vocab 151936"),
    ("medusa", "unknown --spec-decode mode")])
def test_spec_config_from_flag_errors_match_jax(flag, match):
    """Full-width configs: the vocabulary check fires before any weight
    is drawn."""
    with pytest.raises(ValueError, match=match) as got:
        tspec.spec_config_from_flag(flag, get_config("qwen2_0_5b"),
                                    device="cpu")
    from repro.configs.base import get_config as jax_config
    with pytest.raises(ValueError) as want:
        jspec.spec_config_from_flag(flag, jax_config("qwen2_0_5b"))
    assert str(got.value) == str(want.value)


# -- w8a8 ---------------------------------------------------------------------------


@pytest.mark.parametrize("drafter", ["oracle", "ngram"])
@pytest.mark.parametrize("kv", ["float", "int8"])
def test_w8a8_exact_spec_tokens_equal_plain(drafter, kv):
    change = dict(quant=QuantConfig("w8a8"))
    if kv == "int8":
        change["kv_cache_dtype"] = "int8"
    tcfg = dataclasses.replace(get_config("qwen2_0_5b").smoke(), **EXACT,
                               **change)
    params = api.init_params(0, tcfg, "cpu")
    rng = np.random.default_rng(7)
    pair = types.SimpleNamespace(tcfg=tcfg, tparams=params)
    treqs = as_requests(specs(tcfg.vocab_size, 4, rng, new=12))[1]
    ref = torch_engine(pair, decode_horizon=8).generate(treqs)
    d = (OracleDrafter(dict(enumerate(ref))) if drafter == "oracle"
         else tspec.NGramDrafter())
    eng = torch_engine(pair, spec_config=tspec.SpecConfig(d, max_k=4))
    assert eng.generate(treqs) == ref
    st = eng.stats()
    assert st["spec_dispatches"] > 0 or drafter == "ngram"
    if drafter == "oracle":
        assert st["acceptance_rate"] == 1.0
    eng.cache.check_refcounts()


# -- the launcher --------------------------------------------------------------------


def _exact_launcher(monkeypatch):
    real = launcher.get_config
    monkeypatch.setattr(launcher, "get_config",
                        lambda name: dataclasses.replace(real(name), **EXACT))


@pytest.mark.parametrize("flag", ["ngram", "draft"])
def test_launcher_spec_decode_on_the_cpu(flag, monkeypatch, capsys):
    """``--spec-decode``: every request gets its tokens, in exact mode the
    closed batch's."""
    _exact_launcher(monkeypatch)
    argv = ["--arch", "qwen2_0_5b", "--smoke", "--device", "cpu",
            "--engine", "paged", "--requests", "4", "--prompt-len", "12",
            "--new-tokens", "6"]
    plain = launcher.main(argv)
    outs = launcher.main(argv + ["--spec-decode", flag, "--spec-k", "2"])
    assert outs == plain and [len(o) for o in outs] == [6] * 4
    out = capsys.readouterr().out
    assert f"spec={flag}" in out and "'spec_dispatches'" in out


def test_launcher_spec_decode_needs_the_paged_engine():
    with pytest.raises(SystemExit):
        launcher.main(["--arch", "qwen2_0_5b", "--smoke", "--device", "cpu",
                       "--spec-decode", "ngram"])


@pytest.mark.parametrize("choice", ["reference", "auto"])
def test_launcher_ops_backend(choice, monkeypatch, capsys):
    _exact_launcher(monkeypatch)
    argv = ["--arch", "qwen2_0_5b", "--smoke", "--device", "cpu",
            "--engine", "paged", "--requests", "2", "--new-tokens", "4",
            "--ops-backend", choice]
    assert [len(o) for o in launcher.main(argv)] == [4, 4]
    assert f"ops_backend={choice}" in capsys.readouterr().out
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        launcher.main(argv[:-1] + ["cuda"])
