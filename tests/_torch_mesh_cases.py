"""Rank functions of the port's tensor-parallel serving tests.

``repro_torch.launch.mesh.spawn`` runs each in fresh processes joined
over gloo (one CPU thread a rank), so this module imports no JAX: the
weights come in as the JAX ``init_params`` draw's numpy leaves and are
converted in each rank (``params_from_jax``). The trace is
``tests/test_sharded_serve.py``'s on ``qwen2_0_5b.smoke()`` in exact mode
(4 query heads on 2 KV heads): a (1, 2) mesh shards heads and KV heads
alike, (1, 4) shards the heads and replicates the 2 KV heads, (1, 8)
replicates attention while the FFN and the vocabulary shard. A data axis
D splits each 4-lane dispatch 4 / D lanes a rank where D divides 4
((2, 2), (2, 4)) and replicates it at (8, 1); a B = 1 prefill chunk
always replicates.
"""
import collections
import contextlib
import dataclasses

import numpy as np
import torch

from repro_torch import ops
from repro_torch.configs.base import QuantConfig, get_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ailayernorm as KN
from repro_torch.launch.mesh import make_mesh, make_rules, smoke_mesh
from repro_torch.models import api
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.serve.engine import Engine, PagedEngine, Request
from repro_torch.serve.loop import AsyncEngine, ReplicatedAsyncEngine
from repro_torch.serve.spec import DraftModelDrafter, NGramDrafter, SpecConfig
from repro_torch.sharding import comm
from repro_torch.sharding.rules import use_rules

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


def dense_requests(cfg):
    """``tests/test_torch_dense_engine.py``'s mixed prompt lengths (5, 20,
    11, 3, 16, 9; 8 new), served four at a time (left-padded to 20, a
    ragged final chunk padded with zero-budget lanes), then a seeded
    stochastic wave."""
    rng = np.random.default_rng(3)
    greedy = [dict(prompt=rng.integers(0, cfg.vocab_size, n).astype(
        np.int32), max_new_tokens=8) for n in (5, 20, 11, 3, 16, 9)]
    sampled = [dict(prompt=rng.integers(0, cfg.vocab_size, 7 + 3 * i)
                    .astype(np.int32), max_new_tokens=6, temperature=0.8,
                    top_k=8, seed=200 + i) for i in range(4)]
    return greedy, sampled


DENSE_KW = dict(batch_size=4, max_len=32)


def reqs(specs):
    return [Request(**s) for s in specs]


# the projections of a forward; each records its input's lanes (dim 0)
PRODUCTS = ("_project_qkv", "_wo_proj", "apply_mlp", "lm_logits")


@contextlib.contextmanager
def product_lanes():
    """The lanes (leading dim) of every product's input in call order, by
    product (QKV, ``wo``, the MLP, the head): a data rank's products must
    run on its own lanes only."""
    out = collections.defaultdict(list)
    origs = {n: getattr(L, n) for n in PRODUCTS}

    def wrap(name, fn):
        def rec(*a, **kw):
            x = a[0] if name in ("_wo_proj", "apply_mlp") else a[1]
            x = x[0] if isinstance(x, tuple) else x
            out[name].append(int(x.shape[0]))
            return fn(*a, **kw)
        return rec
    for n, f in origs.items():
        setattr(L, n, wrap(n, f))
    try:
        yield out
    finally:
        for n, f in origs.items():
            setattr(L, n, f)


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
    with product_lanes() as lanes:
        out = {"cold": eng.generate(reqs(greedy))}
    out["lanes"] = {k: sorted(set(v)) for k, v in lanes.items()}
    out["warm"] = eng.generate(reqs(greedy))
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
    ranks: (1, 2) on two, (2, 2) on four): the n-gram drafter, and a draft
    model (the target's weights) sharded by its own rules."""
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


def _counted(fn):
    """``fn()``'s collectives (``comm.COUNTS`` moved by it)."""
    before = dict(comm.COUNTS)
    fn()
    return {k: comm.COUNTS[k] - before.get(k, 0) for k in comm.COUNTS
            if comm.COUNTS[k] > before.get(k, 0)}


def w8a8_battery(rank, world, shape, np_params):
    """W8A8 + int8 KV under the mesh: the tokens, every head's logits (the
    rows this rank computed: its lanes of a split dispatch, whole rows
    over the vocabulary), the collectives of one prefill forward and, with
    a data axis, of one 4-lane decode step (null lanes on the null
    page)."""
    cfg = w8a8_cfg()
    params = params_from_jax(np_params, cfg, "cpu")
    rules = _rules(shape)
    eng = PagedEngine(cfg, params, device="cpu", rules=rules, **ENGINE_KW)
    with recorded_logits() as logits:
        toks = eng.generate(reqs(w8a8_requests(cfg)))
    eng.cache.check_refcounts()
    out = {"tokens": toks, "logits": logits,
           "data_index": rules.mesh.coordinate("data")}
    out["counts"] = _counted(lambda: eng.generate(
        [Request(prompt=np.arange(1, 5, dtype=np.int32), max_new_tokens=1)]))
    if shape[0] > 1:
        out["decode_counts"] = decode_counts(eng, cfg, rules)
    return out


def decode_counts(eng, cfg, rules):
    """The collectives of one decode step of ``decode_batch`` null lanes
    (each on the null page) through ``eng``'s weights and pools."""
    b = eng.decode_batch
    zeros = torch.zeros((b,), dtype=torch.int32)
    tables = torch.zeros((b, 8), dtype=torch.int32)

    def step():
        with use_rules(rules):
            T.decode_horizon_paged(
                eng.params, eng.cache.pools, zeros, zeros, tables, None,
                None, None, zeros, torch.full((b, 1), -1, dtype=torch.int32),
                cfg, num_steps=1, use_top_k=False, stochastic=False,
                use_eos=False)
    return _counted(step)


def sole_paged_battery(rank, world, shape, np_params):
    """The SOLE smoke engine (float32, calibrating norms) on ``shape``:
    the tokens of the exact trace's greedy and stochastic requests, and
    every head's logits this rank computed."""
    cfg = get_config("qwen2_0_5b").smoke()
    params = params_from_jax(np_params, cfg, "cpu")
    rules = _rules(shape)
    eng = PagedEngine(cfg, params, device="cpu", rules=rules, **ENGINE_KW)
    greedy, sampled = requests(cfg)
    with recorded_logits() as logits, product_lanes() as lanes:
        toks = eng.generate(reqs(greedy + sampled))
    eng.cache.check_refcounts()
    return {"tokens": toks, "logits": logits,
            "lanes": {k: sorted(set(v)) for k, v in lanes.items()},
            "data_index": rules.mesh.coordinate("data"),
            "decode_counts": decode_counts(eng, cfg, rules)}


# the split norm's cases: rows of the decode step, the 40 rows of a verify
# dispatch, a 128-row chunk; both norm kinds, float32 and bf16, model-dtype
# and int8 out
NORM_ROWS = (8, 40, 128)
NORM_C = 64


def norm_inputs(rows, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((rows, NORM_C), generator=g).mul_(3).to(dtype)
    r = torch.randn((rows, NORM_C), generator=g).to(dtype)
    # one channel's max in one lane only, so a rank's own maxima differ
    x[rows - 1, 5] = 40.0
    gamma = 1 + 0.1 * torch.randn((NORM_C,), generator=g)
    beta = 0.1 * torch.randn((NORM_C,), generator=g)
    return x, r, gamma, beta


def norm_split_battery(rank, world, shape):
    """The calibrating norm on this data rank's share of each case's rows
    with the maxima all-reduced over data: the kernel wrapper's route
    (``calibrated_norm_split``, whose static-params kernels run their
    plain versions here) and the op layer's reference SOLE norms, which
    the model paths reach on the CPU. Returns each case's outputs
    (:func:`host`)."""
    rules = _rules(shape)
    ax = comm.data_axis(rules)

    def red(t):
        return comm.all_reduce_max(t, ax)
    out = {}
    for rows in NORM_ROWS:
        for dtype in (torch.float32, torch.bfloat16):
            for rms in (True, False):
                x, r, gamma, beta = norm_inputs(rows, dtype, rows)
                xl, rl = L.lanes(x, ax), L.lanes(r, ax)
                b = None if rms else beta
                for quant in (False, True):
                    key = (rows, str(dtype), rms, quant)
                    h, res, alpha, scale = KN.calibrated_norm(
                        xl, rl, gamma, b, rms=rms, out_dtype=dtype,
                        quant_out=quant, amax_reduce=red)
                    out[key] = host(h, *(res if quant else (res,)), alpha,
                                    scale)
                kind = "rmsnorm" if rms else "layernorm"
                fn = ops.residual_norm_fn(kind, "sole", "cpu")
                args = (gamma,) if rms else (gamma, beta)
                out[(rows, str(dtype), rms, "op")] = host(*fn(
                    xl, rl, *args, amax_reduce=red))
    out["counts"] = dict(comm.COUNTS)
    return out


def host(*ts):
    """Tensors as (dtype, numpy array) pairs a spawned rank can return:
    floats widened to float32 (exact from bf16), the rest as they are."""
    return [(str(t.dtype), (t.float() if t.is_floating_point() else t)
             .numpy()) for t in ts]


def dense_battery(rank, world, shape, np_params):
    """The dense-slot ``Engine`` under ``shape``'s rules in exact mode:
    the mixed-length greedy trace and the stochastic wave, the lanes of
    every product and the caches' shapes."""
    cfg = exact_cfg()
    params = params_from_jax(np_params, cfg, "cpu")
    rules = _rules(shape)
    eng = Engine(cfg, params, device="cpu", rules=rules, **DENSE_KW)
    greedy, sampled = dense_requests(cfg)
    shapes = []
    orig = api.prefill

    def keep(*a, **kw):
        logits, cache = orig(*a, **kw)
        shapes.append(tuple(cache["k"].shape))
        return logits, cache
    api.prefill = keep
    try:
        with product_lanes() as lanes:
            out = {"greedy": eng.generate(reqs(greedy)),
                   "reasons": list(eng.finish_reasons),
                   "sampled": eng.generate(reqs(sampled))}
    finally:
        api.prefill = orig
    out["lanes"] = {k: sorted(set(v)) for k, v in lanes.items()}
    out["cache_k"] = sorted(set(shapes))
    return out


def admits_battery(rank, world, shape, np_params):
    """What the engines refused before the data axis was ported, served on
    ``shape``: ``PagedEngine``, speculation with a draft model on the
    mesh and the dense-slot ``Engine``, each on two short requests."""
    cfg = exact_cfg()
    params = params_from_jax(np_params, cfg, "cpu")
    rules = _rules(shape)
    specs = short_requests(cfg)
    out = {"paged": PagedEngine(cfg, params, device="cpu", rules=rules,
                                **ENGINE_KW).generate(reqs(specs))}
    draft = DraftModelDrafter(cfg, params, rules=rules)
    out["draft"] = PagedEngine(cfg, params, device="cpu", rules=rules,
                               spec_config=SpecConfig(draft, max_k=2),
                               **ENGINE_KW).generate(reqs(specs))
    out["dense"] = Engine(cfg, params, device="cpu", rules=rules,
                          **DENSE_KW).generate(reqs(specs))
    return out


def short_requests(cfg):
    rng = np.random.default_rng(11)
    return [dict(prompt=rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                 max_new_tokens=3) for n in (6, 9)]


def single_device(cfg, params, specs, **kw):
    """The unsharded port engine's tokens and logits on ``specs``."""
    eng = PagedEngine(cfg, params, device="cpu", **dict(ENGINE_KW, **kw))
    with recorded_logits() as logits:
        toks = eng.generate(reqs(specs))
    eng.cache.check_refcounts()
    return toks, logits
