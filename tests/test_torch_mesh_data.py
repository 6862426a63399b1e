"""The data axis in serving: the port's ``PagedEngine`` and dense-slot
``Engine`` on (D, M) meshes of gloo ranks on the CPU, held to the
single-device engines.

Mirrors ``tests/test_sharded_serve.py``'s (2, 2), (2, 4) and (8, 1) legs,
whose reference fails on this tree with a ``ShardingTypeError``: the
oracle is the JAX single-device ``PagedEngine`` (``rules=None``), computed
once here and shared by every test that reads it. Each mesh shape's
battery is spawned once (``tests/_torch_mesh_cases.py``) and shared by the
tests that read it. A data axis of 2 splits the engines' 4-lane dispatches
2 lanes a rank (the products of each rank run on its own lanes: asserted
from every product's input); 8 data ranks replicate them, as the
reference's ``dim_spec("batch", 4)`` does. Also: SOLE's calibrating norm
on a (2, 1) split with its per-channel maxima all-reduced over data,
bitwise the whole batch's; a SOLE (2, 1) trace, W8A8 + int8 KV on (2, 2)
and speculation on (2, 2) against the single-device port; the dense-slot
``Engine`` on (1, 2), (1, 4) and (2, 2) against the JAX ``Engine``; the
launcher's ``--mesh 2,2`` for both engines.
"""
import pytest
import torch

from repro.serve.engine import Engine as JaxEngine
from repro.serve.engine import PagedEngine as JaxPaged
from repro.serve.engine import Request as JaxRequest
from repro_torch import ops
from repro_torch.configs.base import get_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ailayernorm as KN
from repro_torch.launch.mesh import spawn
from tests import _torch_mesh_cases as C
from tests import _torch_mesh_oracle as O

# (mesh shape, preemption leg, open-loop and replica legs), as the
# reference's SHAPES
SHAPES = [((2, 2), False, False), ((2, 4), True, True),
          ((8, 1), False, False)]
DENSE_SHAPES = [(1, 2), (1, 4), (2, 2)]
_RUNS = {}


@pytest.fixture(scope="module")
def oracle():
    """The JAX single-device engines on the exact smoke config: the paged
    engine's greedy and stochastic tokens, its plain-decode tokens on the
    spec requests, the dense ``Engine``'s tokens on the mixed-length
    trace and its stochastic wave; and the weights as numpy leaves."""
    cfg = O.exact_cfg()
    params = O.params(cfg)
    greedy, sampled = C.requests(cfg)
    eng = JaxPaged(cfg, params, backend="pallas", **C.ENGINE_KW)
    out = {"greedy": eng.generate([JaxRequest(**r) for r in greedy]),
           "sampled": eng.generate([JaxRequest(**r) for r in sampled])}
    eng.cache.check_refcounts()
    out["spec_plain"] = O.tokens(cfg, params, C.spec_requests(cfg),
                                 decode_horizon=8)
    dense = JaxEngine(cfg, params, **C.DENSE_KW)
    dg, ds = C.dense_requests(cfg)
    out["dense_greedy"] = dense.generate([JaxRequest(**r) for r in dg])
    out["dense_reasons"] = list(dense.finish_reasons)
    out["dense_sampled"] = dense.generate([JaxRequest(**r) for r in ds])
    out["params"] = O.numpy_params(params)
    return out


def _spawned(key, fn, world, args):
    if key not in _RUNS:
        _RUNS[key] = spawn(fn, world, args, timeout=C.SPAWN_TIMEOUT)
    return _RUNS[key]


def _battery(shape, oracle):
    _, preempt, use_async = next(s for s in SHAPES if s[0] == shape)
    return _spawned(("paged", shape), C.battery, shape[0] * shape[1],
                    (shape, oracle["params"], preempt, use_async))


@pytest.mark.parametrize("spec", SHAPES,
                         ids=[f"{s[0][0]}x{s[0][1]}" for s in SHAPES])
def test_data_axis_engine_token_parity(spec, oracle):
    """Cold, warm (prefix hits and a COW fork) and stochastic traces, and
    the preempting pool, the open loop and two replicas sharing the tree
    where they run: the JAX single-device tokens on every rank."""
    shape, preempt, use_async = spec
    legs = ["cold", "warm", "sampled"] + ["preempt"] * preempt \
        + ["async", "replicas"] * use_async
    for r, out in enumerate(_battery(shape, oracle)):
        for leg in legs:
            want = oracle["sampled" if leg == "sampled" else "greedy"]
            assert out[leg] == want, (shape, r, leg)
        st = out["warm_stats"]
        assert st["prefix_hit_rate"] > 0 and st["cow_copies"] > 0, st
        if preempt:
            assert out["preemptions"] > 0, (shape, r)
        if use_async:
            assert out["shared_tree"], (shape, r)


@pytest.mark.parametrize("shape,lanes,plan,q_heads,pool_heads", [
    ((2, 2), [1, 2], ("model", True), 2, 1),
    ((2, 4), [1, 2], ("model", False), 1, 2),
    ((8, 1), [1, 4], None, 4, 2)], ids=["2x2", "2x4", "8x1"])
def test_data_axis_lane_split_and_regime(shape, lanes, plan, q_heads,
                                         pool_heads, oracle):
    """Each rank's products (QKV, ``wo``, the MLP, the head) take the B = 1
    prefill chunk whole and, on a data axis of 2, 2 of a decode
    dispatch's 4 lanes; on 8 data ranks all 4 (replicated). The paged
    regime is the model axis's: matched (2, 2), replicated KV (2, 4),
    none (8, 1); the pools hold every page on every data rank."""
    for out in _battery(shape, oracle):
        assert out["lanes"] == {k: lanes for k in C.PRODUCTS}, out["lanes"]
        assert out["plan"] == plan
        assert (out["q_heads"], out["pool_heads"]) == (q_heads, pool_heads)


def _norm_cases():
    for rows in C.NORM_ROWS:
        for dtype in (torch.float32, torch.bfloat16):
            for rms in (True, False):
                yield rows, dtype, rms


def test_calibrating_norm_split_over_data_is_bitwise():
    """The calibrating norm on each (2, 1) rank's half of 8 decode rows, 40
    verify rows and a 128-row chunk (RMS and LayerNorm, float32 and bf16,
    model-dtype and int8 out), its per-channel maxima all-reduced over
    data: h, the output, alpha and the scale bitwise the plain norm's on
    the whole batch, through the kernel wrapper's split route and through
    the op layer's SOLE norm; one max all-reduce of C values a call."""
    ranks = spawn(C.norm_split_battery, 2, ((2, 1),),
                  timeout=C.SPAWN_TIMEOUT)
    calls = 0

    def same(got, *want):
        assert len(got) == len(want)
        for (dt, a), b in zip(got, C.host(*want)):
            assert dt == b[0] and a.tobytes() == b[1].tobytes(), dt
    for rows, dtype, rms in _norm_cases():
        x, r, gamma, beta = C.norm_inputs(rows, dtype, rows)
        for d, out in enumerate(ranks):
            part = slice(d * rows // 2, (d + 1) * rows // 2)
            for quant in (False, True):
                h, res, alpha, scale = KN.calibrated_norm_plain(
                    x, r, gamma, torch.zeros_like(gamma) if rms else beta,
                    rms=rms, out_dtype=dtype, quant_out=quant)
                res = (res[0][part], res[1][part]) if quant else (res[part],)
                same(out[(rows, str(dtype), rms, quant)], h[part], *res,
                     alpha, scale)
            kind = "rmsnorm" if rms else "layernorm"
            args = (gamma,) if rms else (gamma, beta)
            s, want = ops.residual_norm_fn(kind, "sole", "cpu")(x, r, *args)
            same(out[(rows, str(dtype), rms, "op")], s[part], want[part])
        calls += 3
    for out in ranks:
        assert out["counts"]["data.all_reduce_max"] == calls


def _lane_rows(rank_rows, single_rows, d):
    """A rank's recorded logits against the single device's: whole where
    the call replicated (a prefill chunk), else the rank's lanes."""
    assert len(rank_rows) == len(single_rows)
    for a, b in zip(rank_rows, single_rows):
        if a.shape[0] != b.shape[0]:
            n = a.shape[0]
            b = b[d * n:(d + 1) * n]
        assert a.shape == b.shape and a.tobytes() == b.tobytes()


def test_sole_trace_on_2x1_matches_single_device(oracle):
    """The SOLE smoke engine (calibrating norms, E2Softmax) on a (2, 1)
    mesh, each rank decoding 2 of 4 lanes: the single-device port's tokens
    and logits, bit for bit, on the greedy and stochastic requests (each
    norm's maxima all-reduced over data: one max all-reduce a norm and one
    gather of the K/V rows a layer in a decode step, one of the draws)."""
    cfg = get_config("qwen2_0_5b").smoke()
    params = params_from_jax(oracle["params"], cfg, "cpu")
    greedy, sampled = C.requests(cfg)
    toks, logits = C.single_device(cfg, params, greedy + sampled)
    ranks = spawn(C.sole_paged_battery, 2, ((2, 1), oracle["params"]),
                  timeout=C.SPAWN_TIMEOUT)
    n = cfg.n_layers
    for out in ranks:
        assert out["tokens"] == toks
        _lane_rows(out["logits"], logits, out["data_index"])
        assert out["lanes"] == {k: [1, 2] for k in C.PRODUCTS}
        assert out["decode_counts"] == {"data.all_gather": n + 1,
                                        "data.all_reduce_max": 2 * n + 1}


def test_w8a8_mesh_2x2_bitwise(oracle):
    """W8A8 + int8 KV on a (2, 2) mesh: every head's logits bitwise the
    single-device port's (whole rows of a prefill chunk, the rank's lanes
    of a decode step), its tokens; a prefill forward's collectives as on
    (1, 2) and a decode step's the model axis's plus one gather of the
    int8 K/V rows a layer and one of the draws over data."""
    cfg = C.w8a8_cfg()
    params = params_from_jax(oracle["params"], cfg, "cpu")
    toks, logits = C.single_device(cfg, params, C.w8a8_requests(cfg))
    ranks = spawn(C.w8a8_battery, 4, ((2, 2), oracle["params"]),
                  timeout=C.SPAWN_TIMEOUT)
    n = cfg.n_layers
    model = {"all_reduce_sum": 1 + 2 * n, "all_reduce_max": 2 * n,
             "all_gather": 1}
    for out in ranks:
        assert out["tokens"] == toks
        _lane_rows(out["logits"], logits, out["data_index"])
        assert out["counts"] == dict(model, agreed=1), out["counts"]
        assert out["decode_counts"] == dict(
            model, **{"data.all_gather": n + 1}), out["decode_counts"]


def test_spec_decode_on_2x2(oracle):
    """Speculative decoding on a (2, 2) mesh (``smoke_mesh``'s on four
    ranks): the n-gram drafter, and a draft model sharded by its own
    rules whose forward splits its lanes over data, give plain
    single-device decode's tokens."""
    ranks = spawn(C.spec_battery, 4, ((2, 2), oracle["params"]),
                  timeout=C.SPAWN_TIMEOUT)
    for out in ranks:
        for name in ("ngram", "draft"):
            assert out[name] == oracle["spec_plain"], name
            assert out[name + "_stats"]["spec_dispatches"] > 0
        assert out["draft_stats"]["acceptance_rate"] > 0.9


@pytest.mark.parametrize("shape,lanes,cache_k", [
    ((1, 2), [4], (2, 4, 1, 16, 32)),
    ((1, 4), [4], (2, 4, 2, 16, 32)),
    ((2, 2), [2], (2, 2, 1, 16, 32))], ids=["1x2", "1x4", "2x2"])
def test_dense_engine_under_rules(shape, lanes, cache_k, oracle):
    """The dense-slot ``Engine`` under mesh rules in exact mode: the
    mixed-length left-padded trace (with its finish reasons) and the
    stochastic wave give the JAX single-device ``Engine``'s tokens on
    every rank; each rank's products run on its lanes (all 4, or 2 where
    the data axis splits them) and its caches hold its lanes and KV heads
    (matched on (1, 2) and (2, 2), replicated KV on (1, 4))."""
    cfg = C.exact_cfg()
    assert cache_k[0] == cfg.n_layers and cache_k[3] == cfg.head_dim
    ranks = _spawned(("dense", shape), C.dense_battery,
                     shape[0] * shape[1], (shape, oracle["params"]))
    for out in ranks:
        assert out["greedy"] == oracle["dense_greedy"]
        assert out["reasons"] == oracle["dense_reasons"]
        assert out["sampled"] == oracle["dense_sampled"]
        assert out["lanes"] == {k: lanes for k in C.PRODUCTS}, out["lanes"]
        assert out["cache_k"] == [cache_k]


@pytest.mark.parametrize("engine", ["paged", "dense"])
def test_launcher_data_axis_matches_single_device(engine):
    """``launch.serve --mesh 2,2`` (four spawned gloo ranks, SOLE, sampled
    with top-k) for either engine: rank 0 returns the single process's
    tokens."""
    from repro_torch.launch import serve
    argv = ["--arch", "qwen2_0_5b", "--smoke", "--device", "cpu",
            "--engine", engine, "--requests", "5", "--new-tokens", "4",
            "--temperature", "0.7", "--top-k", "5"]
    assert serve.main(argv + ["--mesh", "2,2"]) == serve.main(argv)

