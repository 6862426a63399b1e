"""The port's tensor-parallel paged serving against the JAX single-device
engine, on the CPU.

Mirrors ``tests/test_sharded_serve.py``: its trace on
``qwen2_0_5b.smoke()`` in exact mode, the oracle computed once here by the
JAX ``PagedEngine`` with ``rules=None`` (the reference's sharded engine
fails on this tree with a ``ShardingTypeError``, so its own tests' oracle
is the contract). Each mesh runs in fresh gloo ranks
(``repro_torch.launch.mesh.spawn``, one CPU thread a rank, a timeout per
spawn; the rank functions are in ``tests/_torch_mesh_cases.py``) and each
battery is spawned once per module and shared by the tests that read it.
The meshes cover the reference's three paged regimes: (1, 2) matched,
(1, 4) replicated KV (2 KV heads on a 4-way axis), (1, 8) heads
replicated; (1, 1) is the control. Speculation and W8A8 under the mesh
are in ``tests/test_torch_mesh_spec_w8a8.py``.
"""
import pytest

from repro.serve.engine import PagedEngine as JaxEngine
from repro.serve.engine import Request as JaxRequest
from repro_torch.configs.base import get_config
from repro_torch.convert import params_from_jax
from repro_torch.launch.mesh import Mesh, make_rules, spawn
from repro_torch.serve.engine import Engine, PagedEngine
from repro_torch.serve.spec import DraftModelDrafter
from tests import _torch_mesh_cases as C
from tests import _torch_mesh_oracle as O

# (mesh shape, preemption leg, open-loop leg): the legs run on one mesh
# per sharded regime, as in the reference
SHAPES = [((1, 1), False, False), ((1, 2), True, True),
          ((1, 4), True, True), ((1, 8), False, False)]
_RUNS = {}


@pytest.fixture(scope="module")
def oracle():
    """The JAX single-device engine's greedy and stochastic tokens (one
    engine, as the reference's fixture), and the weights as numpy leaves
    for the ranks."""
    cfg = O.exact_cfg()
    params = O.params(cfg)
    greedy, sampled = C.requests(cfg)
    eng = JaxEngine(cfg, params, backend="pallas", **C.ENGINE_KW)
    out = {"greedy": eng.generate([JaxRequest(**r) for r in greedy]),
           "sampled": eng.generate([JaxRequest(**r) for r in sampled])}
    eng.cache.check_refcounts()
    out["params"] = O.numpy_params(params)
    return out


def _battery(shape, oracle):
    if shape not in _RUNS:
        _, preempt, use_async = next(s for s in SHAPES if s[0] == shape)
        _RUNS[shape] = spawn(C.battery, shape[1],
                             (shape, oracle["params"], preempt, use_async),
                             timeout=C.SPAWN_TIMEOUT)
    return _RUNS[shape]


@pytest.mark.parametrize("spec", SHAPES,
                         ids=[f"{s[0][0]}x{s[0][1]}" for s in SHAPES])
def test_sharded_engine_token_parity(spec, oracle):
    """Cold, warm (prefix hits and a COW fork) and stochastic traces, and
    the preempting pool, the open loop and two replicas sharing the
    sharded tree behind ``ReplicatedAsyncEngine`` where they run: the JAX
    single-device tokens on every rank."""
    shape, preempt, use_async = spec
    ranks = _battery(shape, oracle)
    legs = ["cold", "warm", "sampled"] + ["preempt"] * preempt \
        + ["async", "replicas"] * use_async
    for r, out in enumerate(ranks):
        for leg in legs:
            want = oracle["sampled" if leg == "sampled" else "greedy"]
            assert out[leg] == want, (shape, r, leg)
        st = out["warm_stats"]
        assert st["prefix_hit_rate"] > 0 and st["cow_copies"] > 0, st
        if preempt:
            assert out["preemptions"] > 0, (shape, r)
        if use_async:
            assert out["shared_tree"], (shape, r)


@pytest.mark.parametrize("shape,plan,q_heads,pool_heads", [
    ((1, 1), None, 4, 2),
    ((1, 2), ("model", True), 2, 1),
    ((1, 4), ("model", False), 1, 2),
    ((1, 8), None, 4, 2)], ids=["1x1", "1x2", "1x4", "1x8"])
def test_paged_regime_per_mesh(shape, plan, q_heads, pool_heads, oracle):
    """Each mesh's paged plan and the local shapes it gives: matched
    (1, 2), replicated KV (1, 4), heads replicated (1, 8; the FFN and the
    vocabulary still shard)."""
    for out in _battery(shape, oracle):
        assert out["plan"] == plan
        assert (out["q_heads"], out["pool_heads"]) == (q_heads, pool_heads)
        if shape[1] > 1:
            assert out["dims"]["ff"] == out["dims"]["vocab"] == "model"


def test_gqa_kv_fallback_pinned(oracle):
    """2 KV heads on a 4-way model axis replicate the pool while the 4 q
    heads shard, and the plan still gives the oracle's tokens (the
    reference's ``test_gqa_kv_fallback_pinned``)."""
    for out in _battery((1, 4), oracle):
        assert out["dims"]["heads"] == "model"
        assert out["dims"]["kv_heads"] is None
        assert out["plan"] == ("model", False)
        assert out["cold"] == oracle["greedy"]


def _rules(shape):
    return make_rules(Mesh(shape, ("data", "model")))


@pytest.mark.parametrize("arch", ["mixtral_8x7b", "rwkv6_7b",
                                  "recurrentgemma_9b", "whisper_small",
                                  "qwen2_vl_7b"])
def test_unported_families_raise_under_rules(arch):
    """ssm, hybrid, encdec and vlm under mesh rules raise, naming their
    roadmap item (no silent single-rank fallback); MoE is admitted
    (``tests/test_torch_mesh_moe.py``), so a (1, 2) mesh in a process of
    its own meets the process-group check instead."""
    cfg = get_config(arch).smoke()
    if cfg.family == "moe":
        with pytest.raises(ValueError, match="in a process group of 1"):
            PagedEngine(cfg, {}, device="cpu", rules=_rules((1, 2)))
        return
    with pytest.raises(NotImplementedError, match="queue 1 item 9.2b"):
        PagedEngine(cfg, {}, device="cpu", rules=_rules((1, 2)))


def test_unported_meshes_and_engines_raise_under_rules(oracle):
    """What raised before the data axis was ported (ROADMAP item 9.1) now
    serves: ``PagedEngine`` and a draft model on (2, 1) and (2, 2) meshes
    and the dense-slot ``Engine`` under rules give the single-device
    port's tokens on every rank (the draft model's verify keeps plain
    decode's). A mesh of more ranks than the process group holds still
    raises."""
    cfg = C.exact_cfg()
    params = params_from_jax(oracle["params"], cfg, "cpu")
    specs = C.short_requests(cfg)
    paged = PagedEngine(cfg, params, device="cpu",
                        **C.ENGINE_KW).generate(C.reqs(specs))
    dense = Engine(cfg, params, device="cpu",
                   **C.DENSE_KW).generate(C.reqs(specs))
    for shape in ((2, 1), (2, 2)):
        ranks = spawn(C.admits_battery, shape[0] * shape[1],
                      (shape, oracle["params"]), timeout=C.SPAWN_TIMEOUT)
        for out in ranks:
            assert out["paged"] == out["draft"] == paged, shape
            assert out["dense"] == dense, shape
    for cls in (PagedEngine, Engine):
        with pytest.raises(ValueError, match="in a process group of 1"):
            cls(cfg, params, device="cpu", rules=_rules((2, 2)))
    with pytest.raises(ValueError, match="in a process group of 1"):
        DraftModelDrafter(cfg, params, rules=_rules((2, 1)))


def test_launcher_mesh_matches_single_device():
    """``launch.serve --mesh 1,2`` spawns two gloo ranks whose rank 0
    returns the single-device launcher's tokens (SOLE, the smoke config),
    as do ``--mesh 2,1`` (a data axis) and the dense engine under ``--mesh
    1,2``; nccl on the CPU raises."""
    from repro_torch.launch import serve
    argv = ["--arch", "qwen2_0_5b", "--smoke", "--device", "cpu",
            "--engine", "paged", "--requests", "3", "--new-tokens", "4"]
    single = serve.main(argv)
    assert serve.main(argv + ["--mesh", "1,2"]) == single
    assert serve.main(argv + ["--mesh", "2,1"]) == single
    dense = argv[:-6] + ["--engine", "dense"] + argv[-4:]
    assert serve.main(dense + ["--mesh", "1,2"]) == serve.main(dense)
    with pytest.raises(ValueError, match="only gloo"):
        serve.main(argv + ["--mesh", "1,2", "--dist-backend", "nccl"])
