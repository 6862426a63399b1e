"""Rank functions of the port's tensor-parallel serving tests.

``repro_torch.launch.mesh.spawn`` runs each in fresh processes joined
over gloo (one CPU thread a rank), so this module imports no JAX: the
weights come in as the JAX ``init_params`` draw's numpy leaves and are
converted in each rank (``params_from_jax``). The trace is
``tests/test_sharded_serve.py``'s on ``qwen2_0_5b.smoke()`` in exact mode
(4 query heads on 2 KV heads): a (1, 2) mesh shards heads and KV heads
alike, (1, 4) shards the heads and replicates the 2 KV heads, (1, 8)
replicates attention while the FFN and the vocabulary shard.
"""
import contextlib
import dataclasses

import numpy as np

from repro_torch.configs.base import QuantConfig, get_config
from repro_torch.convert import params_from_jax
from repro_torch.launch.mesh import make_mesh, make_rules, smoke_mesh
from repro_torch.models import layers as L
from repro_torch.serve.engine import PagedEngine, Request
from repro_torch.serve.loop import AsyncEngine, ReplicatedAsyncEngine
from repro_torch.serve.spec import DraftModelDrafter, NGramDrafter, SpecConfig
from repro_torch.sharding import comm

ENGINE_KW = dict(num_blocks=40, block_size=8, max_seq_len=64, max_running=4,
                 decode_batch=4, prefill_chunk=8, decode_horizon=4)
EXACT = dict(softmax_mode="exact", norm_mode="exact", logit_int8=False)
SPAWN_TIMEOUT = 240.0      # seconds for a whole spawned battery


def exact_cfg(**change):
    return dataclasses.replace(get_config("qwen2_0_5b").smoke(), **EXACT,
                               **change)


def w8a8_cfg():
    """``tests/test_quantized_ops.py``'s mesh config, with int8 KV pages."""
    return exact_cfg(quant=QuantConfig(mode="w8a8"), kv_cache_dtype="int8")


def requests(cfg):
    """``tests/test_sharded_serve.py``'s trace: two identical prompts (a
    COW fork on the partial third block), one diverging after two full
    blocks, and a seeded stochastic wave."""
    rng = np.random.default_rng(7)
    shared = rng.integers(0, cfg.vocab_size, size=20).astype(np.int32)
    tail = rng.integers(0, cfg.vocab_size, size=6).astype(np.int32)
    greedy = [dict(prompt=shared, max_new_tokens=6, eos_ids=(7,)),
              dict(prompt=shared.copy(), max_new_tokens=6),
              dict(prompt=np.concatenate([shared[:16], tail]),
                   max_new_tokens=6)]
    sampled = [dict(prompt=shared[:12], max_new_tokens=6, temperature=0.8,
                    top_k=8, seed=100 + i) for i in range(3)]
    return greedy, sampled


def w8a8_requests(cfg):
    """``tests/test_quantized_ops.py``'s mesh requests."""
    rng = np.random.default_rng(0)
    return [dict(prompt=rng.integers(0, cfg.vocab_size, size=9 + 3 * i)
                 .astype(np.int32), max_new_tokens=8) for i in range(3)]


def spec_requests(cfg):
    """Greedy and sampled requests whose prompts repeat, so the n-gram
    drafter proposes."""
    rng = np.random.default_rng(41)
    out = []
    for i in range(4):
        base = rng.integers(0, cfg.vocab_size, size=6).astype(np.int32)
        kw = dict(temperature=0.9, top_k=6, seed=5) if i >= 2 else {}
        out.append(dict(prompt=np.concatenate([base, base, base[:4]]),
                        max_new_tokens=8, **kw))
    return out


def reqs(specs):
    return [Request(**s) for s in specs]


@contextlib.contextmanager
def recorded_logits():
    """Every ``layers.lm_logits`` result (whole rows, after the gather)
    copied to host memory, in call order."""
    out, orig = [], L.lm_logits

    def rec(*a, **kw):
        logits = orig(*a, **kw)
        out.append(logits.detach().cpu().numpy().copy())
        return logits
    L.lm_logits = rec
    try:
        yield out
    finally:
        L.lm_logits = orig


def _rules(shape):
    return make_rules(make_mesh(shape, ("data", "model")))


def battery(rank, world, shape, np_params, preempt, use_async):
    """The sharded engine's traces on ``shape``: cold, warm (prefix hits,
    COW) and stochastic, then a tight pool that preempts and an
    ``AsyncEngine`` open loop where asked. Returns the tokens, the stats
    and the paged attention's plan."""
    cfg = exact_cfg()
    params = params_from_jax(np_params, cfg, "cpu")
    rules = _rules(shape)
    greedy, sampled = requests(cfg)
    eng = PagedEngine(cfg, params, device="cpu", rules=rules, **ENGINE_KW)
    out = {"cold": eng.generate(reqs(greedy)),
           "warm": eng.generate(reqs(greedy))}
    out["warm_stats"] = eng.stats()
    out["sampled"] = eng.generate(reqs(sampled))
    eng.cache.check_refcounts()
    out["pool_heads"] = int(eng.cache.pools["k"].shape[3])
    out["q_heads"] = int(eng.params["layers"]["attn"]["wq"].shape[2])
    out["plan"] = L._paged_tp_plan(rules, cfg.n_heads, cfg.n_kv_heads)
    out["dims"] = {ax: rules.dim_spec(ax, n) for ax, n in (
        ("heads", cfg.n_heads), ("kv_heads", cfg.n_kv_heads),
        ("ff", cfg.d_ff), ("vocab", cfg.padded_vocab))}
    if preempt:
        tight = PagedEngine(cfg, params, device="cpu", rules=rules,
                            **dict(ENGINE_KW, num_blocks=8, watermark=0))
        out["preempt"] = tight.generate(reqs(greedy))
        out["preemptions"] = tight.stats()["preemptions"]
        tight.cache.check_refcounts()
    if use_async:
        loop = AsyncEngine(eng)
        hs = [loop.add_request(r, arrival=3 * i)
              for i, r in enumerate(reqs(greedy))]
        loop.run()
        out["async"] = [h.tokens for h in hs]
        eng.cache.check_refcounts()
        # a replica on the same rules takes the sharded tree as it is
        twin = PagedEngine(cfg, eng.params, device="cpu", rules=rules,
                           **ENGINE_KW)
        out["shared_tree"] = all(
            a is b for a, b in zip(_tensors(twin.params),
                                   _tensors(eng.params)))
        rep = ReplicatedAsyncEngine([eng, twin])
        hs = [rep.add_request(r) for r in reqs(greedy)]
        rep.run()
        out["replicas"] = [h.tokens for h in hs]
        for e in (eng, twin):
            e.cache.check_refcounts()
    return out


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    else:
        yield tree


def spec_battery(rank, world, shape, np_params):
    """Speculative decoding under the mesh (``smoke_mesh``'s, cut to the
    ranks: (1, 2) on two): the n-gram drafter, and a draft model (the
    target's weights) sharded by its own rules."""
    cfg = exact_cfg()
    params = params_from_jax(np_params, cfg, "cpu")
    mesh = smoke_mesh(data=2, model=2)
    assert mesh.devices.shape == tuple(shape), mesh
    rules = make_rules(mesh)
    out = {}
    for name in ("ngram", "draft"):
        drafter = (NGramDrafter() if name == "ngram" else
                   DraftModelDrafter(cfg, params, rules=rules))
        eng = PagedEngine(cfg, params, device="cpu", rules=rules,
                          spec_config=SpecConfig(drafter, max_k=4),
                          **dict(ENGINE_KW, decode_horizon=8))
        out[name] = eng.generate(reqs(spec_requests(cfg)))
        out[name + "_stats"] = eng.stats()
        eng.cache.check_refcounts()
    return out


def w8a8_battery(rank, world, shape, np_params):
    """W8A8 + int8 KV under the mesh: the tokens, every head's logits
    (whole rows) and the collectives of one prefill forward."""
    cfg = w8a8_cfg()
    params = params_from_jax(np_params, cfg, "cpu")
    eng = PagedEngine(cfg, params, device="cpu", rules=_rules(shape),
                      **ENGINE_KW)
    with recorded_logits() as logits:
        toks = eng.generate(reqs(w8a8_requests(cfg)))
    eng.cache.check_refcounts()
    before = dict(comm.COUNTS)
    eng.generate([Request(prompt=np.arange(1, 5, dtype=np.int32),
                          max_new_tokens=1)])
    counts = {k: comm.COUNTS[k] - before.get(k, 0) for k in comm.COUNTS}
    return {"tokens": toks, "logits": logits, "counts": counts}


def single_device(cfg, params, specs, **kw):
    """The unsharded port engine's tokens and logits on ``specs``."""
    eng = PagedEngine(cfg, params, device="cpu", **dict(ENGINE_KW, **kw))
    with recorded_logits() as logits:
        toks = eng.generate(reqs(specs))
    eng.cache.check_refcounts()
    return toks, logits
