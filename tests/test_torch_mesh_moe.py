"""The MoE family under mesh rules: the port's MoE FFN routes and its
``PagedEngine``/dense-slot ``Engine`` on (1, 2), (2, 1) and (2, 2) meshes
of gloo ranks on the CPU, held to the JAX package.

Configs ``mixtral_8x7b.smoke()`` and ``dbrx_132b.smoke()`` (4 experts,
top-2), exact and SOLE modes. The FFN's routes (``models/moe.py``): (a)
expert parallelism over data (4 lanes split 2 a rank, two ``all_to_all``),
(b) a batch replicated over data while the experts lie over it (one lane
of 8 tokens, one sum over data), (c) expert-FF tensor parallelism over
model (one sum over model). Oracles, computed once per module:

* (a) and (c): ``repro.models.moe.apply_moe_ffn`` jitted under a
  4-fake-device JAX mesh in a subprocess (``tests/_mesh_helpers``), the
  same numpy weights and activations, within 1e-6 of the largest output
  (float32: the router and expert products sum in another order,
  ``tests/test_torch_moe.py``'s bar; TP adds the partials' float32 sum);
* (b): the reference cannot take it (its EP fallback gives each shard
  the whole buffer while the weight specs keep the experts over data), so
  the unsharded call: bitwise the port's unsharded call on (2, 1) (top-2:
  at most two non-zero terms a token), within 1e-6 of it with TP, and
  within 1e-6 of JAX's unsharded call;
* the engines: the JAX single-device ``PagedEngine`` and ``Engine`` on
  ``tests/_torch_mesh_cases.py``'s traces.

Each mesh's battery (``tests/_torch_mesh_moe_cases.py``) is spawned once
and shared by the tests that read it.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_config
from repro.models import api as japi
from repro.models import moe as JM
from repro.serve.engine import Engine as JaxEngine
from repro.serve.engine import PagedEngine as JaxPaged
from repro.serve.engine import Request as JaxRequest
from repro_torch.convert import params_from_jax
from repro_torch.launch.mesh import spawn
from repro_torch.models import moe as TM
from tests import _torch_mesh_cases as C
from tests import _torch_mesh_moe_cases as MC
from tests._mesh_helpers import run_with_devices

MESHES = ((1, 2), (2, 1), (2, 2))
JOBS = {(1, 2): ("ffn", "paged", "dense", "refusals"),
        (2, 1): ("ffn", "paged", "spec", "all_to_all"),
        (2, 2): ("ffn", "paged", "dense", "all_to_all")}
TOL = 1e-6
CAPS = ("paged", None)
_RUNS = {}


def _ids(shape):
    return f"{shape[0]}x{shape[1]}"


def _jax_cfg(arch, mode):
    cfg = jax_config(arch).smoke()
    return dataclasses.replace(cfg, **C.EXACT) if mode == "exact" else cfg


def _key(arch, xs, cap, shape):
    """An output's name in the reference's mesh run."""
    return f"{arch}_{xs[0]}x{xs[1]}_{cap}_{shape[0]}x{shape[1]}"


_MESH_FFN = """
import dataclasses
import jax, numpy as np
from jax.sharding import Mesh
from repro.configs.base import get_config
from repro.models import moe as JM
from repro.sharding import rules as R
src = np.load({path!r})
out = {{}}
for arch in {archs!r}:
    cfg = dataclasses.replace(get_config(arch).smoke(), **{exact!r})
    p = {{k: src[arch + "_" + k] for k in ("router", "gate", "up", "down")}}
    for xs, shapes in {cases!r}:
        x = src[arch + "_x%dx%d" % xs]
        for cap in {caps!r}:
            c = None if cap is None else x.shape[0] * x.shape[1]
            for shape in shapes:
                devs = np.array(jax.devices()[:shape[0] * shape[1]])
                mesh = Mesh(devs.reshape(shape), ("data", "model"))
                with mesh, R.use_rules(R.Rules(mesh)):
                    y = jax.jit(lambda p, x: JM.apply_moe_ffn(
                        p, x, cfg, "serve", capacity=c)[0])(p, x)
                out["%s_%dx%d_%s_%dx%d" % ((arch,) + xs + (cap,) + shape)] = (
                    np.asarray(y))
np.savez({out_path!r}, **out)
"""


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    """The JAX side, once: each config's weights as numpy leaves; the
    single-device ``PagedEngine``'s greedy and stochastic tokens per
    config and mode; the dense ``Engine``'s in exact mode; the unsharded
    FFN of each op-level input; and the reference's mesh FFN (a subprocess
    with 4 fake devices) on (1, 2), (2, 1) and (2, 2) where it runs."""
    out = {"params": {}, "paged": {}, "dense": {}, "ffn": {}}
    tmp = tmp_path_factory.mktemp("moe_mesh")
    arrays = {}
    for arch in MC.ARCHS:
        jp = japi.init_params(jax.random.PRNGKey(0), _jax_cfg(arch, "exact"))[0]
        out["params"][arch] = jax.tree.map(np.asarray, jp)
        mlp = MC.layer0_mlp(out["params"][arch])
        for k, v in mlp.items():
            arrays[f"{arch}_{k}"] = v
        for xs in (MC.SPLIT_X, MC.WHOLE_X):
            x = MC.ffn_inputs(arch, xs)
            arrays[f"{arch}_x{xs[0]}x{xs[1]}"] = x
            for cap in CAPS:
                c = None if cap is None else x.shape[0] * x.shape[1]
                out["ffn"][(arch, xs, cap, None)] = np.asarray(jax.jit(
                    lambda p, x: JM.apply_moe_ffn(
                        p, x, _jax_cfg(arch, "exact"), "serve",
                        capacity=c)[0])(mlp, x))
        for mode in MC.MODES:
            cfg = _jax_cfg(arch, mode)
            greedy, sampled = C.requests(cfg)
            eng = JaxPaged(cfg, jp, backend="pallas", **C.ENGINE_KW)
            toks = eng.generate([JaxRequest(**r) for r in greedy])
            toks += eng.generate([JaxRequest(**r) for r in sampled])
            eng.cache.check_refcounts()
            out["paged"][(arch, mode)] = toks
        cfg = _jax_cfg(arch, "exact")
        dg, ds = C.dense_requests(cfg)
        dense = JaxEngine(cfg, jp, **C.DENSE_KW)
        out["dense"][arch] = (dense.generate([JaxRequest(**r) for r in dg])
                              + dense.generate([JaxRequest(**r) for r in ds]))
    src, dst = str(tmp / "in.npz"), str(tmp / "out.npz")
    np.savez(src, **arrays)
    # the reference raises on a replicated batch with the experts over
    # data (module docstring): WHOLE_X runs on (1, 2) only
    cases = ((MC.SPLIT_X, MESHES), (MC.WHOLE_X, ((1, 2),)))
    run_with_devices(_MESH_FFN.format(path=src, archs=MC.ARCHS,
                                      exact=C.EXACT, cases=cases, caps=CAPS,
                                      out_path=dst), n_devices=4)
    with np.load(dst) as got:
        for arch in MC.ARCHS:
            for xs, shapes in cases:
                for cap in CAPS:
                    for shape in shapes:
                        out["ffn"][(arch, xs, cap, shape)] = got[
                            _key(arch, xs, cap, shape)]
    return out


def _battery(shape, oracle):
    if shape not in _RUNS:
        _RUNS[shape] = spawn(MC.battery, shape[0] * shape[1],
                             (shape, oracle["params"], JOBS[shape]),
                             timeout=C.SPAWN_TIMEOUT)
    return _RUNS[shape]


def _close(got, want):
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= TOL * float(np.abs(want).max()), err


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)], ids=_ids)
def test_all_to_all_over_gloo(shape, oracle):
    """``comm.all_to_all`` over the data axis (the data groups of a (2, 2)
    mesh too): rank i's chunk j reaches rank j as its chunk i, in float32,
    int32 and bf16 (as its bytes), each call counted under
    ``data.all_to_all``."""
    for out in _battery(shape, oracle):
        ex = out["all_to_all"]
        me = out["data_index"]
        want = (100 * np.arange(2)[:, None] + 10 * me
                + np.arange(3)[None]).astype(np.float32)
        for dt in ("torch.float32", "torch.int32", "torch.bfloat16"):
            np.testing.assert_array_equal(ex[dt], want)
        assert ex["counted"] == 3


@pytest.mark.parametrize("cap", CAPS, ids=["paged", "formula"])
@pytest.mark.parametrize("arch", MC.ARCHS)
@pytest.mark.parametrize("shape", MESHES, ids=_ids)
def test_ffn_routes_match_reference_mesh(shape, arch, cap, oracle):
    """4 lanes of 3 tokens: on a data axis of 2 route (a) (each rank's 2
    lanes, two ``all_to_all`` over data), on a model axis of 2 route (c)
    (one sum over model), both on (2, 2); every rank's gathered rows
    within 1e-6 of the reference's ``apply_moe_ffn`` on the same mesh,
    with the paged capacity (the whole dispatch's tokens) and with the
    capacity-factor formula (the rank's tokens, as inside the reference's
    ``shard_map``)."""
    want = oracle["ffn"][(arch, MC.SPLIT_X, cap, shape)]
    d, m = shape
    counts = {}
    if d > 1:
        counts.update({"data.all_to_all": 2, "data.all_gather": 1})
    if m > 1:
        counts["all_reduce_sum"] = 1
    for out in _battery(shape, oracle):
        got, ran = out[("ffn", arch, MC.SPLIT_X, cap)]
        _close(got, want)
        assert ran == counts, ran


@pytest.mark.parametrize("arch", MC.ARCHS)
@pytest.mark.parametrize("shape", MESHES, ids=_ids)
def test_ffn_replicated_batch(shape, arch, oracle):
    """One lane of 8 tokens (a paged prefill chunk) replicates over data:
    with the experts over data, route (b) (each rank its experts' rows,
    one sum over data of the partial outputs). On (2, 1) bitwise the
    port's unsharded call; with TP within 1e-6 of it; every mesh within
    1e-6 of JAX's unsharded call, and of the reference's own (1, 2)
    mesh."""
    cfg = MC.cfg_of(arch, "exact")
    mlp = params_from_jax({"layers": {"mlp": MC.layer0_mlp(
        oracle["params"][arch])}}, cfg, "cpu")["layers"]["mlp"]
    x = torch.from_numpy(MC.ffn_inputs(arch, MC.WHOLE_X))
    d, m = shape
    for cap in CAPS:
        single = (TM._paged_ffn(mlp, x, cfg, "serve") if cap == "paged"
                  else TM.apply_moe_ffn(mlp, x, cfg, "serve")[0]).numpy()
        counts = {"data.all_reduce_sum": 1} if d > 1 else {}
        if m > 1:
            counts["all_reduce_sum"] = 1
        for out in _battery(shape, oracle):
            got, ran = out[("ffn", arch, MC.WHOLE_X, cap)]
            assert ran == counts, ran
            if m == 1:
                assert got.tobytes() == single.tobytes()
            _close(got, single)
            _close(got, oracle["ffn"][(arch, MC.WHOLE_X, cap, None)])
            if shape == (1, 2):
                _close(got, oracle["ffn"][(arch, MC.WHOLE_X, cap, shape)])


@pytest.mark.parametrize("mode", MC.MODES)
@pytest.mark.parametrize("arch", MC.ARCHS)
@pytest.mark.parametrize("shape", MESHES, ids=_ids)
def test_paged_engine_tokens(shape, arch, mode, oracle):
    """``PagedEngine(rules=)``: the cold greedy trace (a COW fork, an eos)
    then the stochastic wave on one engine give the JAX single-device
    ``PagedEngine``'s tokens on every rank."""
    for out in _battery(shape, oracle):
        assert out[("paged", arch, mode)]["tokens"] == \
            oracle["paged"][(arch, mode)]


@pytest.mark.parametrize("shape", MESHES, ids=_ids)
def test_paged_decode_step_collectives(shape, oracle):
    """The collectives of one 4-lane decode step (null lanes): the dense
    backbone's (``wo`` and the embedding summed over model, the head
    gathered; over data the K/V rows and the draws gathered, SOLE's
    maxima all-reduced) plus the MoE FFN's: one sum over model a layer
    on a model axis, two ``all_to_all`` over data a layer on a data
    axis."""
    d, m = shape
    n = MC.cfg_of("mixtral_8x7b", "exact").n_layers
    for mode in MC.MODES:
        want = {}
        if m > 1:
            want.update({"all_reduce_sum": 1 + 2 * n, "all_gather": 1})
        if d > 1:
            want.update({"data.all_to_all": 2 * n, "data.all_gather": n + 1})
            if mode == "sole":
                want["data.all_reduce_max"] = 2 * n + 1
        for arch in MC.ARCHS:
            for out in _battery(shape, oracle):
                assert out[("paged", arch, mode)]["decode_step"] == want


@pytest.mark.parametrize("arch", MC.ARCHS)
@pytest.mark.parametrize("shape", [(1, 2), (2, 2)], ids=_ids)
def test_dense_engine_under_rules(shape, arch, oracle):
    """The dense-slot ``Engine`` in exact mode on the mixed-length trace
    and the stochastic wave: on (1, 2) (TP only, the capacity formula on
    the whole batch) the JAX single-device ``Engine``'s tokens; on (2, 2)
    (EP: the formula on each rank's lanes, so drops may differ from one
    card's, as the reference's) every rank's tokens agree."""
    ranks = _battery(shape, oracle)
    toks = [out[("dense", arch)] for out in ranks]
    assert all(t == toks[0] for t in toks)
    assert [len(t) for t in toks[0]] == \
        [len(t) for t in oracle["dense"][arch]]
    if shape == (1, 2):
        assert toks[0] == oracle["dense"][arch]


@pytest.mark.parametrize("arch", MC.ARCHS)
def test_ngram_spec_on_2x1(arch, oracle):
    """n-gram speculation on (2, 1) in exact mode (verify dispatches
    through route (a)): every rank's tokens are plain decode's on the same
    mesh, with verify dispatches that accepted drafts."""
    for out in _battery((2, 1), oracle):
        res = out[("spec", arch)]
        assert res["spec"] == res["plain"]
        assert res["stats"]["spec_dispatches"] > 0
        assert res["stats"]["spec_accepted_tokens"] > 0


def test_refusals_under_rules(oracle):
    """Inside a (1, 2) group: MoE with W8A8 raises in both engines (the
    reference has no quantized MoE path); rwkv6, recurrentgemma, whisper
    and qwen2-vl raise naming ROADMAP item 9.2b."""
    ref = _battery((1, 2), oracle)[0]["refusals"]
    for key in ("paged_w8a8", "dense_w8a8"):
        kind, msg = ref[key]
        assert kind == "NotImplementedError" and "no quantized MoE" in msg
    for arch in MC.REFUSED:
        kind, msg = ref[arch]
        assert kind == "NotImplementedError" and "queue 1 item 9.2b" in msg


def test_launcher_moe_mesh_matches_single_process():
    """``launch.serve --arch mixtral_8x7b --mesh 2,2`` (four spawned gloo
    ranks, paged, SOLE, sampled with top-k): rank 0 returns the single
    process's tokens."""
    from repro_torch.launch import serve
    argv = ["--arch", "mixtral_8x7b", "--smoke", "--device", "cpu",
            "--engine", "paged", "--requests", "4", "--new-tokens", "4",
            "--temperature", "0.7", "--top-k", "5"]
    assert serve.main(argv + ["--mesh", "2,2"]) == serve.main(argv)
