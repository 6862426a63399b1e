"""Shared cases of the recurrent families' serve tests
(``tests/test_torch_ssm_serve.py``, ``tests/test_torch_hybrid_serve.py``):
the cases of the reference's ``tests/test_multiarch_serve.py`` for the ssm
(``rwkv6_7b`` smoke) and hybrid (``recurrentgemma_9b`` smoke at 4 layers,
one tail layer: one rec-rec-attention block) families, each trace through
the port's engines on the CPU and through the JAX package's on the same
weights, token for token.

The reference's alignment constraints hold here too: the hybrid's RG-LRU
scan tree depends on the chunk, so its cold trace against the dense
oracle prefills each prompt in one chunk and its preemption trace uses
``prefill_chunk == 1``; the dense ``Engine`` shares positions across
lanes for recurrent families, so its batches take equal-length prompts.
JAX's paged engine runs the paged attention as its own tests run it on
the CPU (``backend="pallas"``: interpret mode).
"""
import dataclasses

import jax
import numpy as np

from repro.configs.base import get_config as jax_config
from repro.models import api as japi
from repro.serve.engine import Engine as JaxDense
from repro.serve.engine import PagedEngine as JaxPaged
from repro.serve.engine import Request as JaxRequest
from repro.serve.loop import AsyncEngine as JaxLoop
from repro_torch.configs.base import get_config
from repro_torch.convert import params_from_jax
from repro_torch.serve.engine import Engine, PagedEngine, Request
from repro_torch.serve.loop import AsyncEngine

ARCH = {"ssm": ("rwkv6_7b", {}),
        "hybrid": ("recurrentgemma_9b", dict(n_layers=4, n_tail_layers=1))}
EXACT = dict(softmax_mode="exact", norm_mode="exact", logit_int8=False)
PAGED_KW = dict(num_blocks=24, block_size=4, max_seq_len=32, max_running=2,
                decode_batch=2, prefill_chunk=8, decode_horizon=4)
SOLE_TOKEN_AGREEMENT = 0.95


class Fam:
    """One family's smoke model on both sides: configs and weights."""

    def __init__(self, fam, mode="exact"):
        name, over = ARCH[fam]
        modes = EXACT if mode == "exact" else {}
        self.fam = fam
        self.jcfg = dataclasses.replace(jax_config(name).smoke(), **over,
                                        **modes)
        self.tcfg = dataclasses.replace(get_config(name).smoke(), **over,
                                        **modes)
        self.jparams = japi.init_params(0, self.jcfg)[0]
        self.tparams = params_from_jax(jax.tree.map(np.asarray,
                                                    self.jparams),
                                       self.tcfg, "cpu")

    def with_mode(self, mode):
        """The same weights under another mode's config."""
        other = object.__new__(Fam)
        other.__dict__.update(self.__dict__)
        modes = EXACT if mode == "exact" else dict(
            softmax_mode="sole", norm_mode="sole", logit_int8=True)
        other.jcfg = dataclasses.replace(self.jcfg, **modes)
        other.tcfg = dataclasses.replace(self.tcfg, **modes)
        return other

    def paged(self, **kw):
        """(JAX engine, port engine) with the same arguments."""
        return self.jax_paged(**kw), self.port_paged(**kw)

    def jax_paged(self, **kw):
        return JaxPaged(self.jcfg, self.jparams, backend="pallas",
                        **dict(PAGED_KW, **kw))

    def port_paged(self, **kw):
        return PagedEngine(self.tcfg, self.tparams, device="cpu",
                           **dict(PAGED_KW, **kw))

    def dense(self, **kw):
        return (JaxDense(self.jcfg, self.jparams, **kw),
                Engine(self.tcfg, self.tparams, device="cpu", **kw))


def specs(cfg, n, seed, plen=8, new=6, **kw):
    rng = np.random.default_rng(seed)
    return [dict(prompt=rng.integers(0, cfg.vocab_size, size=plen)
                 .astype(np.int32), max_new_tokens=new, **kw)
            for _ in range(n)]


def requests(spec_list):
    """(JAX requests, port requests) of the same specs."""
    return ([JaxRequest(**s) for s in spec_list],
            [Request(**s) for s in spec_list])


def assert_drained(eng):
    """No leaked pages or slots after a trace."""
    st = eng.stats()
    assert st["blocks_in_use"] == 0
    eng.cache.check_refcounts()
    assert st["state_slots_in_use"] == 0
    assert st["free_state_slots"] == eng.slot_pool.num_slots - 1
    eng.slot_pool.check_slots()
    assert st["state_footprint_bytes"] == 0


def assert_same_stats(jeng, teng):
    jst, tst = jeng.stats(), teng.stats()
    common = sorted(set(jst) & set(tst))
    assert len(common) >= 25
    assert {k: tst[k] for k in common} == {k: jst[k] for k in common}


def cold_vs_dense(f: Fam):
    """The port's paged queue and dense Engine reproduce the JAX dense
    Engine's greedy continuations in exact mode (prompts of one chunk;
    JAX's own paged engine equals its dense one in the reference's
    tests)."""
    jreq, treq = requests(specs(f.tcfg, 4, 7))
    jd, td = f.dense(batch_size=4, max_len=32)
    want = jd.generate(jreq)
    assert td.generate(treq) == want
    teng = f.port_paged()
    assert teng.generate(treq) == want
    assert_drained(teng)


def warm_prefix(f: Fam):
    """A second admission of seen prompts restores the block-boundary
    state (``prefill_chunk == block_size``: a checkpoint at every block)
    and lands on the cold tokens; the hybrid also attaches its pages."""
    jreq, treq = requests(specs(f.tcfg, 2, 3, plen=12))
    jeng, teng = f.paged(prefill_chunk=4)
    cold = jeng.generate(jreq)
    assert teng.generate(treq) == cold
    assert teng.stats()["state_checkpoints"] > 0
    assert jeng.generate(jreq) == teng.generate(treq) == cold
    st = teng.stats()
    # prompt_len 12, block 4: boundaries 4 and 8 are checkpointed (the
    # last block is recomputed), so each warm admission skips 8 tokens
    assert st["checkpoint_hit_tokens"] >= 8
    if f.fam == "hybrid":
        assert st["prefix_hit_tokens"] >= 8
    assert_drained(teng)
    assert_same_stats(jeng, teng)


def preempt(f: Fam):
    """A tight pool with watermark 0 forces recompute-preemption; the
    replay lands on the roomy run's tokens (``prefill_chunk == 1``: every
    segmentation is the same sequential recurrence)."""
    jreq, treq = requests(specs(f.tcfg, 4, 9))
    kw = dict(prefill_chunk=1, prefix_cache=False)
    want = f.port_paged(**kw).generate(treq)
    jeng, teng = f.paged(num_blocks=5, watermark=0, **kw)
    assert jeng.generate(jreq) == want
    assert teng.generate(treq) == want
    assert teng.stats()["preemptions"] > 0
    assert_drained(teng)
    assert_same_stats(jeng, teng)


def eos(f: Fam):
    """An eos id cuts the continuation right after its first occurrence,
    as the dense path defines; finish reasons as the reference's."""
    jreq, treq = requests(specs(f.tcfg, 1, 17, new=8))
    base = f.port_paged().generate(treq)[0]
    tok = int(base[3])
    want = base[:base.index(tok) + 1]
    jeng, teng = f.paged()
    req = dataclasses.replace(treq[0], eos_ids=(tok,))
    jr = dataclasses.replace(jreq[0], eos_ids=(tok,))
    assert teng.generate([req])[0] == jeng.generate([jr])[0] == want
    assert teng.stats()["finish_reasons"] == {"eos": 1}
    assert_drained(teng)


def async_loop(f: Fam):
    """Staggered open-loop arrivals through ``AsyncEngine`` land on the
    closed ``generate()`` tokens, and on the JAX loop's."""
    spec_list = specs(f.tcfg, 3, 19, new=4)
    jreq, treq = requests(spec_list)
    want = f.port_paged().generate(treq)
    jeng, teng = f.paged()
    jloop, tloop = JaxLoop(jeng), AsyncEngine(teng)
    jh = [jloop.add_request(r, arrival=2 * i) for i, r in enumerate(jreq)]
    th = [tloop.add_request(r, arrival=2 * i) for i, r in enumerate(treq)]
    jloop.run()
    tloop.run()
    assert [h.tokens for h in th] == [h.tokens for h in jh] == want
    assert_drained(teng)


def o1_state(f: Fam):
    """A sequence's recurrent state is one fixed-size slot: the same bytes
    per slot whatever the prompt length (the reference spec's
    ``slot_bytes``), at most ``max_running`` slots; the ssm holds no
    page."""
    per_slot = []
    for plen in (8, 24):
        _, treq = requests(specs(f.tcfg, 2, 1, plen=plen, new=4))
        teng = f.port_paged()
        assert all(len(o) == 4 for o in teng.generate(treq))
        st = teng.stats()
        assert st["peak_state_slots_in_use"] <= 2
        if f.fam == "ssm":
            assert st["peak_blocks_in_use"] == 0
        per_slot.append(st["state_bytes_per_slot"])
        assert_drained(teng)
    want = japi.sequence_state_spec(f.jcfg).slot_bytes()
    assert per_slot[0] == per_slot[1] == want > 0


def sole_agreement(f: Fam):
    """SOLE mode: the paged trace's greedy tokens agree with the JAX
    engine's on at least ``SOLE_TOKEN_AGREEMENT`` of them (a norm code can
    flip on a one-ulp difference)."""
    s = f.with_mode("sole")
    jreq, treq = requests(specs(s.tcfg, 4, 23, plen=10, new=6))
    jeng, teng = s.paged(prefill_chunk=4)
    want, got = jeng.generate(jreq), teng.generate(treq)
    pairs = [(a, b) for x, y in zip(want, got) for a, b in zip(x, y)]
    assert all(len(x) == len(y) for x, y in zip(want, got))
    agree = sum(a == b for a, b in pairs) / len(pairs)
    assert agree >= SOLE_TOKEN_AGREEMENT, (want, got)
    assert_drained(teng)


def capability_errors(f: Fam):
    """Speculative decoding and int8 weights raise on both sides with the
    reference's messages (the hybrid's max_seq_len past its window too);
    the spec flags are the reference's."""
    import pytest
    from repro.serve.spec import NGramDrafter as JaxNGram
    from repro.serve.spec import SpecConfig as JaxSpec
    from repro_torch.configs.base import QuantConfig
    from repro_torch.serve.spec import NGramDrafter, SpecConfig
    msg = "does not support speculative decoding"
    with pytest.raises(ValueError, match=msg):
        JaxPaged(f.jcfg, f.jparams, spec_config=JaxSpec(JaxNGram(), max_k=4),
                 **PAGED_KW)
    with pytest.raises(ValueError, match=msg):
        PagedEngine(f.tcfg, f.tparams, device="cpu",
                    spec_config=SpecConfig(NGramDrafter(), max_k=4),
                    **PAGED_KW)
    with pytest.raises(ValueError, match="no quantized serving path"):
        PagedEngine(dataclasses.replace(f.tcfg, quant=QuantConfig("w8a8")),
                    f.tparams, device="cpu", **PAGED_KW)
    if f.fam == "hybrid":
        over = dict(PAGED_KW, max_seq_len=f.tcfg.window + 1)
        for make in (lambda: JaxPaged(f.jcfg, f.jparams, **over),
                     lambda: PagedEngine(f.tcfg, f.tparams, device="cpu",
                                         **over)):
            with pytest.raises(ValueError, match="append-only"):
                make()
