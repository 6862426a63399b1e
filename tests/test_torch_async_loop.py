"""The port's streaming loop (``AsyncEngine``, ``ReplicatedAsyncEngine``)
on the CPU against the JAX package's, on the same traces: the seven cases
of the reference's ``tests/test_async_loop.py`` (open-loop arrivals FCFS,
streaming callbacks and iterators, cancellation as a finish event, the
latency accounting, the eos early exit) and the prefix router.

Both loops wrap a ``PagedEngine`` over the same smoke weights in exact
mode (the JAX one with its Pallas kernels in interpret mode). Tokens,
finish reasons, each request's surfacing steps (TTFT and ITL in engine
steps) and every ``stats()`` entry but the wall-clock ones are equal;
the wall latencies are checked for shape only.
"""
import dataclasses

import numpy as np
import pytest

from _torch_serve_helpers import (as_requests, common_stats, jax_engine,
                                  smoke_pair, specs, torch_engine)
from repro.serve.loop import AsyncEngine as JaxAsyncEngine
from repro.serve.loop import ReplicatedAsyncEngine as JaxReplicated
from repro_torch.launch import serve as launcher
from repro_torch.serve.loop import AsyncEngine, ReplicatedAsyncEngine

LOOP_KW = dict(decode_horizon=4)
WALL_KEYS = ("ttft_ms", "itl_ms")


@pytest.fixture(scope="module")
def exact_lm():
    return smoke_pair()


def _loops(pair, **kw):
    """(JAX loop, port loop) over engines built with the same arguments."""
    kw = dict(LOOP_KW, **kw)
    return (JaxAsyncEngine(jax_engine(pair, **kw)),
            AsyncEngine(torch_engine(pair, **kw)))


def _timeline(handles):
    return [(h.tokens, h.finish_reason, h.arrival, h.first_token_step,
             h.finish_step, h.token_steps, h.ttft_steps(), h.itl_steps())
            for h in handles]


def _loop_stats(loop):
    st = dict(loop.stats())
    for k in WALL_KEYS:
        assert set(st.pop(k)) == {"p50", "p99"}
    return st


def _assert_same_stats(jloop, tloop):
    js, ts = _loop_stats(jloop), _loop_stats(tloop)
    je, te = common_stats(js.pop("engine"), ts.pop("engine"))
    assert ts == js
    assert te == je


def _closed(pair, reqs):
    return torch_engine(pair, **LOOP_KW).generate(as_requests(reqs)[1])


def test_async_matches_closed_batch(exact_lm):
    pair = exact_lm
    reqs = specs(pair.tcfg.vocab_size, 4, np.random.default_rng(7), plen=12)
    closed = _closed(pair, reqs)
    hs = []
    for loop, rs in zip(_loops(pair), as_requests(reqs)):
        seen = []
        handles = [loop.add_request(r, arrival=3 * i,
                                    on_token=lambda h, t: seen.append((h, t)))
                   for i, r in enumerate(rs)]
        loop.run()
        for h in handles:
            assert [t for hh, t in seen if hh is h] == h.tokens
        loop.engine.cache.check_refcounts()
        assert loop.engine.cache.blocks_in_use == 0
        hs.append((loop, handles))
    (jloop, jh), (tloop, th) = hs
    assert [h.tokens for h in th] == closed
    assert _timeline(th) == _timeline(jh)
    assert all(h.finish_reason == "length" and h.ttft_steps() >= 1
               for h in th)
    _assert_same_stats(jloop, tloop)


def test_fcfs_admission_and_future_arrivals(exact_lm):
    pair = exact_lm
    reqs = specs(pair.tcfg.vocab_size, 3, np.random.default_rng(1), plen=12,
                 new=4)
    res = []
    for loop, rs in zip(_loops(pair, max_running=1), as_requests(reqs)):
        late = loop.add_request(rs[0], arrival=9)
        a = loop.add_request(rs[1])
        b = loop.add_request(rs[2])
        loop.step()
        assert a._seq is not None and b._seq is not None
        assert late._seq is None
        assert a._seq.seq_id < b._seq.seq_id
        loop.run()
        assert late.first_token_step > 9
        res.append((loop, [late, a, b]))
    assert _timeline(res[1][1]) == _timeline(res[0][1])
    _assert_same_stats(res[0][0], res[1][0])


def test_streaming_iterator_drives_loop(exact_lm):
    pair = exact_lm
    reqs = specs(pair.tcfg.vocab_size, 1, np.random.default_rng(7), plen=12)
    closed = _closed(pair, reqs)
    streams = []
    for loop, rs in zip(_loops(pair), as_requests(reqs)):
        h = loop.add_request(rs[0])
        streams.append(list(h))
        assert h.finished and h.finish_reason == "length"
    assert streams[1] == streams[0] == closed[0]


def test_cancellation_is_a_finish_event(exact_lm):
    pair = exact_lm
    reqs = specs(pair.tcfg.vocab_size, 4, np.random.default_rng(7), plen=12)
    closed = _closed(pair, reqs)
    res = []
    for loop, rs in zip(_loops(pair), as_requests(reqs)):
        handles = [loop.add_request(r) for r in rs]
        while handles[1].first_token_step is None:
            loop.step()
        in_use = loop.engine.cache.blocks_in_use
        assert handles[1].cancel()
        assert loop.engine.cache.blocks_in_use < in_use
        assert not handles[1].cancel()
        loop.run()
        st = loop.stats()
        assert st["finish_reasons"] == {"cancelled": 1, "length": 3}
        assert st["engine"]["finish_reasons"] == {"cancelled": 1,
                                                  "length": 3}
        assert loop.engine.sched.cancelled == 1
        loop.engine.cache.check_refcounts()
        assert loop.engine.cache.blocks_in_use == 0
        res.append((loop, handles))
    th = res[1][1]
    assert th[1].finish_reason == "cancelled"
    assert 0 < len(th[1].tokens) < 8
    assert [th[i].tokens for i in (0, 2, 3)] == [closed[i] for i in (0, 2, 3)]
    assert _timeline(th) == _timeline(res[0][1])
    _assert_same_stats(res[0][0], res[1][0])


def test_cancel_queued_request(exact_lm):
    pair = exact_lm
    reqs = specs(pair.tcfg.vocab_size, 2, np.random.default_rng(2), plen=12,
                 new=4)
    res = []
    for loop, rs in zip(_loops(pair), as_requests(reqs)):
        hq = loop.add_request(rs[0], arrival=50)
        hr = loop.add_request(rs[1])
        assert hq.cancel()
        loop.run()
        assert hq.finish_reason == "cancelled" and hq.tokens == []
        assert hr.finish_reason == "length"
        assert loop.engine.steps < 50
        res.append((loop, [hq, hr]))
    assert _timeline(res[1][1]) == _timeline(res[0][1])
    _assert_same_stats(res[0][0], res[1][0])


def test_latency_stats_shape(exact_lm):
    pair = exact_lm
    reqs = specs(pair.tcfg.vocab_size, 3, np.random.default_rng(3), plen=12,
                 new=6)
    loops = _loops(pair)
    for loop, rs in zip(loops, as_requests(reqs)):
        for i, r in enumerate(rs):
            loop.add_request(r, arrival=2 * i)
        loop.run()
    st = loops[1].stats()
    assert st["completed"] == 3
    for key in ("ttft_steps", "itl_steps") + WALL_KEYS:
        assert set(st[key]) == {"p50", "p99"}
        assert st[key]["p99"] >= st[key]["p50"] >= 0
    assert st["ttft_steps"]["p50"] >= 1
    assert st["engine"]["finished"] == 3
    _assert_same_stats(*loops)


def test_early_exit_saves_engine_steps(exact_lm):
    """A Poisson trace where half the requests hit eos about half-way
    finishes in fewer engine steps than the same trace without eos, each
    eos request cut right after its eos token, the rest unchanged."""
    pair = exact_lm
    rng = np.random.default_rng(5)
    reqs = specs(pair.tcfg.vocab_size, 6, rng, plen=12, new=12)
    arrivals = np.cumsum(rng.exponential(0.5, 6)).astype(int).tolist()
    kw = dict(num_blocks=48, decode_horizon=8, max_running=6,
              decode_batch=6)

    def run(rs, loop):
        hs = [loop.add_request(r, arrival=t) for r, t in zip(rs, arrivals)]
        loop.run()
        loop.engine.cache.check_refcounts()
        assert loop.engine.cache.blocks_in_use == 0
        return hs

    base = run(as_requests(reqs)[1], _loops(pair, **kw)[1])
    base_tokens = [h.tokens for h in base]
    eos_reqs = [dict(r, eos_ids=(int(o[6]),)) if i % 2 == 0 else r
                for i, (r, o) in enumerate(zip(reqs, base_tokens))]
    jloop, tloop = _loops(pair, **kw)
    jh = run(as_requests(eos_reqs)[0], jloop)
    th = run(as_requests(eos_reqs)[1], tloop)
    assert _timeline(th) == _timeline(jh)
    _assert_same_stats(jloop, tloop)
    assert tloop.engine.steps < base[0]._loop.engine.steps
    assert tloop.stats()["finish_reasons"]["eos"] >= 1
    for r, h, b in zip(eos_reqs, th, base_tokens):
        if r.get("eos_ids"):
            hit = [i for i, t in enumerate(b) if t in r["eos_ids"]]
            assert h.tokens == b[:hit[0] + 1] and len(h.tokens) < len(b)
        else:
            assert h.tokens == b


# -- replicas behind the prefix router ---------------------------------------


def _replica_trace(vocab, seed=11):
    """Eight requests: four on two shared 16-token system prompts (routed
    by prefix) and four shorter than a page (routed by load)."""
    rng = np.random.default_rng(seed)
    systems = [rng.integers(0, vocab, 16) for _ in range(2)]
    reqs = [dict(prompt=np.concatenate(
                [systems[i % 2], rng.integers(0, vocab, 4)]).astype(np.int32),
                 max_new_tokens=6) for i in range(4)]
    reqs += specs(vocab, 4, rng, plen=5, new=6)
    arrivals = np.cumsum(rng.exponential(2.0, len(reqs))).astype(int)
    return reqs, arrivals.tolist()


@pytest.mark.parametrize("n", [1, 2, 3])
def test_replicated_routing_and_outputs_match_jax(exact_lm, n):
    """Routing decisions, per-replica outputs and stats equal JAX's; in
    exact mode every request's tokens equal one engine's closed batch."""
    pair = exact_lm
    reqs, arrivals = _replica_trace(pair.tcfg.vocab_size)
    closed = _closed(pair, reqs)
    jreqs, treqs = as_requests(reqs)
    jeng = jax_engine(pair, **LOOP_KW)
    teng = torch_engine(pair, **LOOP_KW)
    jrep = JaxReplicated([jeng] + [jax_engine(pair, **LOOP_KW)
                                   for _ in range(n - 1)])
    trep = ReplicatedAsyncEngine(
        [teng] + [_replica_of(teng, pair) for _ in range(n - 1)])
    assert [trep.route(r) for r in treqs] == [jrep.route(r) for r in jreqs]
    hs = []
    for rep, rs in ((jrep, jreqs), (trep, treqs)):
        hs.append([rep.add_request(r, arrival=a, on_token=None)
                   for r, a in zip(rs, arrivals)])
        rep.run()
        for loop in rep.replicas:
            loop.engine.cache.check_refcounts()
            assert loop.engine.cache.blocks_in_use == 0
    assert [h.tokens for h in hs[1]] == closed
    assert _timeline(hs[1]) == _timeline(hs[0])
    js, ts = jrep.stats(), trep.stats()
    for k in ("replicas", "completed", "decode_tokens", "steps",
              "routed_by_prefix", "routed_by_load"):
        assert ts[k] == js[k], k
    assert ts["routed_by_prefix"] == 4 and ts["routed_by_load"] == 4
    for jr, tr in zip(jrep.replicas, trep.replicas):
        _assert_same_stats(jr, tr)


def _replica_of(engine, pair):
    """A replica engine over ``engine``'s parameter tree (shared, not
    copied)."""
    rep = torch_engine(pair._replace(tparams=engine.params), **LOOP_KW)
    assert rep.params["embed"]["table"] is engine.params["embed"]["table"]
    return rep


def test_replicated_needs_an_engine():
    with pytest.raises(ValueError):
        ReplicatedAsyncEngine([])


# -- the launcher -------------------------------------------------------------


def _exact_launcher(monkeypatch):
    real = launcher.get_config
    monkeypatch.setattr(
        launcher, "get_config", lambda name: dataclasses.replace(
            real(name), softmax_mode="exact", norm_mode="exact",
            logit_int8=False))


@pytest.mark.parametrize("extra", [["--stream"], ["--replicas", "2"],
                                   ["--spec-decode", "ngram", "--stream"]],
                         ids=["stream", "replicas", "spec-stream"])
def test_launcher_open_loop_on_the_cpu(extra, monkeypatch, capsys):
    """``--open-loop 0.5``: every request gets its tokens, in exact mode
    the closed batch's; ``--stream`` prints each surfaced token."""
    _exact_launcher(monkeypatch)
    argv = ["--arch", "qwen2_0_5b", "--smoke", "--device", "cpu",
            "--engine", "paged", "--requests", "5", "--prompt-len", "12",
            "--new-tokens", "6"]
    closed = launcher.main(argv)
    capsys.readouterr()
    outs = launcher.main(argv + ["--open-loop", "0.5"] + extra)
    assert outs == closed and [len(o) for o in outs] == [6] * 5
    out = capsys.readouterr().out
    assert "engine=paged(open-loop)" in out
    if "--stream" in extra:
        assert out.count(" -> ") == 30
    if "--replicas" in extra:
        assert "replicas=2" in out and "routing:" in out
    else:
        assert "TTFT steps p50/p99" in out


def test_launcher_replicas_need_the_open_loop():
    with pytest.raises(SystemExit):
        launcher.main(["--arch", "qwen2_0_5b", "--smoke", "--device", "cpu",
                       "--engine", "paged", "--replicas", "2"])
