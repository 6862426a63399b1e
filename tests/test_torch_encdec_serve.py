"""The encdec family (``whisper_small`` smoke: 2 + 2 layers, cross_len 32)
through the port's ``PagedEngine`` and ``AsyncEngine`` on the CPU against
the JAX package's ``PagedEngine`` on the same weights: the reference's
encdec serve cases (``tests/test_multiarch_serve.py``: the cold trace
against the dense-cache oracle, preemption that re-encodes, the open
loop, frames required, prefix caching and speculation refused) token for
token in exact mode, with every serving counter both report; SOLE mode at
least 95% of tokens equal. Also: the cross pages' host bookkeeping against
``repro.serve.kv_cache`` on one operation sequence, the launcher, and the
refusal of int8 KV pages, whose reference run parts from its own float
pages (its cross pages are read back cast, not dequantized).

JAX's engine runs its paged attention as its own tests run it on the CPU
(``backend="pallas"``: interpret mode); its tokens on the shared request
set are computed once (the ``shared`` fixture).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_config
from repro.models import api as japi
from repro.serve.engine import PagedEngine as JaxPaged
from repro.serve.engine import Request as JaxRequest
from repro.serve.kv_cache import PagedKVCache as JaxCache
from repro_torch.configs.base import QuantConfig, get_config
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as launcher
from repro_torch.models import api
from repro_torch.serve import engine as E
from repro_torch.serve.kv_cache import PagedKVCache
from repro_torch.serve.loop import AsyncEngine
from repro_torch.serve.sampling import Sampler

EXACT = dict(softmax_mode="exact", norm_mode="exact", logit_int8=False)
# the reference's encdec engine: 24 pages of 4 tokens, two lanes
PAGED_KW = dict(num_blocks=24, block_size=4, max_seq_len=32, max_running=2,
                decode_batch=2, prefill_chunk=4, decode_horizon=4)
ROOMY = dict(PAGED_KW, num_blocks=48)
# per sequence 8 cross pages (cross_len 32 / 4) and at most 3 self pages:
# 20 pages admit two but starve their decode growth
TIGHT = dict(PAGED_KW, num_blocks=20, watermark=0)
SOLE_TOKEN_AGREEMENT = 0.95


class Pair:
    """The whisper smoke model on both sides: configs and weights."""

    def __init__(self, mode="exact"):
        kw = EXACT if mode == "exact" else {}
        self.jcfg = dataclasses.replace(jax_config("whisper_small").smoke(),
                                        **kw)
        self.tcfg = dataclasses.replace(get_config("whisper_small").smoke(),
                                        **kw)
        self.jparams = japi.init_params(0, self.jcfg)[0]
        self.tparams = params_from_jax(jax.tree.map(np.asarray,
                                                    self.jparams),
                                       self.tcfg, "cpu")

    def jax_paged(self, **kw):
        return JaxPaged(self.jcfg, self.jparams, backend="pallas",
                        **dict(PAGED_KW, **kw))

    def port_paged(self, **kw):
        return E.PagedEngine(self.tcfg, self.tparams, device="cpu",
                             **dict(PAGED_KW, **kw))


def specs(vocab, n, seed, plen=4, new=6, n_frames=8, d=64):
    rng = np.random.default_rng(seed)
    return [dict(prompt=rng.integers(0, vocab, size=plen).astype(np.int32),
                 max_new_tokens=new,
                 frames=(rng.standard_normal((n_frames, d)) * 0.1)
                 .astype(np.float32))
            for _ in range(n)]


def requests(spec_list):
    return ([JaxRequest(**s) for s in spec_list],
            [E.Request(**s) for s in spec_list])


def assert_drained(eng):
    st = eng.stats()
    assert st["blocks_in_use"] == 0 and st["state_footprint_bytes"] == 0
    eng.cache.check_refcounts()
    assert not eng.cache._cross_tables


def assert_same_stats(jeng, teng):
    jst, tst = jeng.stats(), teng.stats()
    common = sorted(set(jst) & set(tst))
    assert len(common) >= 23
    assert {k: tst[k] for k in common} == {k: jst[k] for k in common}


@pytest.fixture(scope="module")
def pair():
    return Pair()


@pytest.fixture(scope="module")
def shared(pair):
    """The shared request set (four requests, 8 frames each) and the JAX
    engine's tokens for it, with the engine."""
    spec_list = specs(pair.tcfg.vocab_size, 4, 13)
    jreq, _ = requests(spec_list)
    jeng = pair.jax_paged(**ROOMY)
    return spec_list, jeng.generate(jreq), jeng


def test_cold_paged_matches_dense_oracle_and_jax(pair, shared):
    """The encoder runs once at admission and the cross K/V park in
    private pages: the port's paged tokens equal its own dense-cache
    greedy loop (``prefill`` + ``decode_step``, the reference test's
    oracle) and the JAX engine's, with the same counters."""
    spec_list, want, jeng = shared
    _, treq = requests(spec_list)
    m = api.get_model(pair.tcfg)
    oracle = []
    for s in spec_list:
        plen, new = len(s["prompt"]), s["max_new_tokens"]
        logits, cache = m.prefill(
            pair.tparams, {"frames": torch.tensor(s["frames"])[None],
                           "tokens": torch.tensor(s["prompt"])[None]},
            pair.tcfg, plen + new)
        smp = Sampler(vocab_size=pair.tcfg.vocab_size)
        out = [smp(logits[0, -1].numpy())]
        for i in range(1, new):
            logits, cache = m.decode_step(
                pair.tparams, cache, torch.tensor([out[-1]], dtype=torch.int32),
                plen + i - 1, pair.tcfg)
            out.append(smp(logits[0].numpy()))
        oracle.append(out)
    teng = pair.port_paged(**ROOMY)
    assert teng.generate(treq) == oracle == want
    assert_drained(teng)
    assert_same_stats(jeng, teng)


def test_preemption_reencodes_and_matches(pair, shared, monkeypatch):
    """A tight pool with watermark 0 preempts; a preempted sequence drops
    its cross pages and re-runs the encoder on re-admission, landing on
    the roomy run's tokens, as the JAX engine does with the same counts."""
    spec_list, want, _ = shared
    jreq, treq = requests(spec_list)
    encodes = [0]
    real = api.encode_paged

    def counted(*a, **kw):
        encodes[0] += 1
        return real(*a, **kw)
    monkeypatch.setattr(api, "encode_paged", counted)
    jeng, teng = pair.jax_paged(**TIGHT), pair.port_paged(**TIGHT)
    assert jeng.generate(jreq) == want
    assert teng.generate(treq) == want
    st = teng.stats()
    assert st["preemptions"] > 0
    assert encodes[0] == len(treq) + st["preemptions"]
    assert_drained(teng)
    assert_same_stats(jeng, teng)


def test_async_loop_staggered_arrivals(pair, shared):
    """Open-loop arrivals two steps apart through ``AsyncEngine`` carry
    each request's frames and land on the closed trace's tokens."""
    spec_list, want, _ = shared
    _, treq = requests(spec_list)
    teng = pair.port_paged(**ROOMY)
    loop = AsyncEngine(teng)
    handles = [loop.add_request(r, arrival=2 * i) for i, r in enumerate(treq)]
    loop.run()
    assert [h.tokens for h in handles] == want
    assert all(h.finish_reason == "length" for h in handles)
    assert_drained(teng)


def test_sole_tokens_agree_with_jax():
    """SOLE mode (the encoder's norms calibrate over the request's frames):
    at least 95% of greedy tokens equal the JAX engine's."""
    s = Pair("sole")
    jreq, treq = requests(specs(s.tcfg.vocab_size, 4, 23, plen=6))
    want = s.jax_paged(**ROOMY).generate(jreq)
    teng = s.port_paged(**ROOMY)
    got = teng.generate(treq)
    assert all(len(a) == len(b) for a, b in zip(want, got))
    pairs = [(a, b) for x, y in zip(want, got) for a, b in zip(x, y)]
    assert np.mean([a == b for a, b in pairs]) >= SOLE_TOKEN_AGREEMENT
    assert_drained(teng)


def test_frames_required(pair):
    """A request without frames raises at submission on both sides, and
    ``generate`` leaves nothing queued."""
    spec_list = specs(pair.tcfg.vocab_size, 2, 2)
    for s in spec_list:
        s.pop("frames")
    jreq, treq = requests(spec_list)
    jeng, teng = pair.jax_paged(), pair.port_paged()
    for eng, reqs in ((jeng, jreq), (teng, treq)):
        with pytest.raises(ValueError, match="needs encoder frames"):
            eng.generate(reqs)
    assert not teng.sched.has_work


@pytest.mark.parametrize("kw,match", [
    (dict(prefix_cache=True), "does not support prefix caching"),
    ("spec", "does not support speculative decoding")])
def test_capabilities_refused_like_reference(pair, kw, match):
    """Prefix caching and speculative decoding raise with the reference's
    messages (cross pages are per request; verify is dense-only)."""
    from repro.serve.spec import NGramDrafter as JaxNGram
    from repro.serve.spec import SpecConfig as JaxSpec
    from repro_torch.serve.spec import NGramDrafter, SpecConfig
    jkw = tkw = kw
    if kw == "spec":
        jkw = dict(spec_config=JaxSpec(JaxNGram(), max_k=4))
        tkw = dict(spec_config=SpecConfig(NGramDrafter(), max_k=4))
    with pytest.raises(ValueError, match=match):
        pair.jax_paged(**jkw)
    with pytest.raises(ValueError, match=match):
        pair.port_paged(**tkw)


def test_quantized_and_int8_kv_refused(pair):
    """int8 weights raise as the reference's engine does; int8 KV pages
    raise ``NotImplementedError`` naming the reference line whose cross
    pages are read undequantized, where the JAX engine serves other tokens
    with int8 pages than with float pages on the same requests."""
    with pytest.raises(ValueError, match="no quantized serving path"):
        E.PagedEngine(dataclasses.replace(pair.tcfg,
                                          quant=QuantConfig("w8a16")),
                      pair.tparams, device="cpu", **PAGED_KW)
    with pytest.raises(NotImplementedError, match="whisper.py:318-320"):
        E.PagedEngine(dataclasses.replace(pair.tcfg, kv_cache_dtype="int8"),
                      pair.tparams, device="cpu", **PAGED_KW)
    jreq, _ = requests(specs(pair.tcfg.vocab_size, 3, 11))
    kw = dict(PAGED_KW, backend="reference")
    floats = JaxPaged(pair.jcfg, pair.jparams, **kw).generate(jreq)
    int8 = JaxPaged(dataclasses.replace(pair.jcfg, kv_cache_dtype="int8"),
                    pair.jparams, **kw).generate(jreq)
    assert int8 != floats


def test_engines_refuse_what_the_reference_refuses(pair):
    """The dense-slot ``Engine`` serves LM families only (encdec and vlm
    raise the reference's message); ``PagedEngine`` refuses vlm as not
    paged-servable."""
    vcfg = get_config("qwen2_vl_7b").smoke()
    vparams = api.init_params(0, vcfg, "cpu")
    for cfg, params in ((pair.tcfg, pair.tparams), (vcfg, vparams)):
        with pytest.raises(ValueError, match="Engine serves LM families"):
            E.Engine(cfg, params, device="cpu")
    with pytest.raises(ValueError, match="not paged-servable"):
        E.PagedEngine(vcfg, vparams, device="cpu")


def test_cross_pages_bookkeeping_matches_reference():
    """One operation sequence (cross and self allocations, growth, a
    failed cross allocation, releases) on the port's ``PagedKVCache`` and
    on the reference's: the same page ids, tables, free counts and
    refcounts after every step; the invariant sweep counts cross pages."""
    tcfg = get_config("whisper_small").smoke()
    jcfg = jax_config("whisper_small").smoke()
    kw = dict(num_blocks=24, block_size=4, max_seq_len=32, prefix_cache=False)
    t, j = PagedKVCache(tcfg, device="cpu", **kw), JaxCache(jcfg, **kw)

    def same():
        assert t._ref == j._ref and t._free == j._free
        assert t._cross_tables == j._cross_tables
        assert t._tables == j._tables
        assert t.blocks_in_use == j.blocks_in_use
        assert t.peak_blocks_in_use == j.peak_blocks_in_use
        t.check_refcounts()
        j.check_refcounts()
    ops = [("attach", 0), ("cross", 0, 32), ("grow", 0, 0, 6),
           ("attach", 1), ("cross", 1, 30), ("grow", 1, 0, 9),
           ("attach", 2), ("cross", 2, 32), ("release", 0),
           ("cross", 2, 32), ("grow", 2, 0, 4), ("release", 1),
           ("release", 2)]
    for op in ops:
        for c in (t, j):
            if op[0] == "attach":
                c.attach(op[1], [])
            elif op[0] == "cross":
                if c.has_cross(op[1]):
                    with pytest.raises(ValueError, match="already"):
                        c.alloc_cross(op[1], op[2])
                    continue
                got = c.alloc_cross(op[1], op[2])
                assert got is None or len(got) == c.blocks_for_tokens(op[2])
            elif op[0] == "grow":
                c.append_tokens(*op[1:])
            else:
                c.release(op[1])
        same()
        if op[0] == "cross" and t.has_cross(op[1]):
            assert np.array_equal(t.cross_row(op[1], 10),
                                  j.cross_row(op[1], 10))
            sids = [op[1], None, 99]
            assert np.array_equal(t.batch_cross(sids, 8),
                                  j.batch_cross(sids, 8))
    assert t.alloc_cross(5, 4 * 24) is None and not t.has_cross(5)
    assert t.free_blocks == 23


def test_launcher_serves_whisper_on_the_cpu(capsys):
    """``--arch whisper_small --smoke --engine paged`` serves requests with
    synthetic encoder frames; ``--engine dense`` and ``qwen2_vl_7b`` raise
    the reference engines' errors."""
    argv = ["--arch", "whisper_small", "--smoke", "--device", "cpu",
            "--requests", "3", "--prompt-len", "6", "--new-tokens", "4"]
    outs = launcher.main(argv + ["--engine", "paged"])
    assert [len(o) for o in outs] == [4] * 3
    assert "device=cpu" in capsys.readouterr().out
    with pytest.raises(ValueError, match="Engine serves LM families"):
        launcher.main(argv)
    with pytest.raises(ValueError, match="not paged-servable"):
        launcher.main(["--arch", "qwen2_vl_7b", "--smoke", "--device", "cpu",
                       "--engine", "paged"])


def test_paged_decode_inputs_shape_the_cross_refs():
    """The refs the engine builds for a padded batch: (B, NBc) cross
    tables with null rows for null lanes, and ``cross_valid`` of 1 on a
    null lane (one garbage null-page key, never an all-masked row)."""
    p = Pair()
    eng = p.port_paged(**ROOMY)
    s = specs(p.tcfg.vocab_size, 1, 3, n_frames=12)[0]
    seq = eng.submit(E.Request(**s))
    eng.sched.admit()
    eng._init_state(seq)
    refs = eng._refs([seq, None])
    assert refs["cross"].shape == (2, 8)
    assert refs["cross"][1].tolist() == [0] * 8
    assert refs["cross"][0].tolist() == eng.cache.cross_row(seq.seq_id).tolist()
    assert refs["cross_valid"].tolist() == [12, 1]
