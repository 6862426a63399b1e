"""The port's mesh rules against the JAX package's, with no process group.

``Rules`` reads only a mesh's axis names and shape, so both sides get a
stand-in mesh (the port's ``launch.mesh.Mesh`` without a group, a
namespace with a ``devices`` array for the reference). For every config
of the package, at full width and at ``.smoke()`` size, every parameter
leaf's spec, FSDP spec and ZeRO-1 spec (and the packed W8A8 tree's, for
the families with quantized serving) equals the reference's on each
listed mesh; ``models.api.param_axes`` equals the axes tree
``repro.models.api.init_params`` returns; ``convert.shard_params`` is a
bitwise slice of the single-device tree; ``layers._paged_tp_plan`` gives
the reference's plan. The reference's ``shard_map`` is never run (it
fails on this tree).
"""
import dataclasses
import types

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ARCH_NAMES
from repro.configs.base import get_config as jax_config
from repro.models import api as japi
from repro.models import layers as JL
from repro.sharding import rules as JR
from repro_torch.configs.base import QuantConfig, get_config
from repro_torch.convert import params_from_jax, shard_params
from repro_torch.launch.mesh import Mesh
from repro_torch.models import api
from repro_torch.models import layers as L
from repro_torch.sharding import rules as R

MESHES = [((1, 2), ("data", "model")), ((1, 4), ("data", "model")),
          ((1, 7), ("data", "model")), ((1, 8), ("data", "model")),
          ((2, 2), ("data", "model")), ((2, 4), ("data", "model")),
          ((8, 1), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
MESH_IDS = ["x".join(map(str, m[0])) for m in MESHES]


def _rules(shape, names):
    ref = JR.Rules(types.SimpleNamespace(axis_names=names,
                                         devices=np.empty(shape)))
    return ref, R.Rules(Mesh(shape, names))


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _shape_tree(tree):
    if isinstance(tree, dict):
        return {k: _shape_tree(v) for k, v in tree.items()}
    return tuple(tree.shape)


def _cfg(arch, smoke):
    cfg = get_config(arch)
    return cfg.smoke() if smoke else cfg


def _shapes(cfg):
    """Every leaf's shape (meta tensors: no memory at full width); the
    packed tree's under ``cfg.quant.weights``."""
    params = api.init_params(0, cfg, "meta")
    if cfg.quant.weights:
        params = R.quantize_params(params)
    return params


def _assert_specs(cfg, ref, mine):
    axes = api.param_axes(cfg)
    params = _shapes(cfg)
    specs = R.param_specs(axes, _shape_tree(params), mine)
    for path, leaf in _leaves(params):
        ax, shape = _get(axes, path), tuple(leaf.shape)
        spec = mine.spec(ax, shape)
        assert spec == tuple(ref.spec(ax, shape)), (cfg.name, path)
        assert _get(specs, path) == spec, (cfg.name, path)
        assert R.fsdp_param_spec(shape, mine) == tuple(
            JR.fsdp_param_spec(shape, ref)), (cfg.name, path)
        assert R.zero1_spec(spec, shape, mine) == tuple(
            JR.zero1_spec(JR.P(*spec), shape, ref)), (cfg.name, path)


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_specs_match_reference(arch, mesh):
    """Every leaf's spec, FSDP spec and ZeRO-1 spec, full width and
    smoke size."""
    ref, mine = _rules(*mesh)
    for smoke in (False, True):
        _assert_specs(_cfg(arch, smoke), ref, mine)


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ["qwen2_0_5b", "stablelm_1_6b",
                                  "minitron_8b", "nemotron_4_15b"])
def test_quantized_specs_match_reference(arch, mesh):
    """The packed W8A8 tree's specs: the scale's size-1 contraction dims
    replicate, its out dims shard with the codes."""
    ref, mine = _rules(*mesh)
    for smoke in (False, True):
        cfg = dataclasses.replace(_cfg(arch, smoke),
                                  quant=QuantConfig("w8a8"))
        _assert_specs(cfg, ref, mine)


@pytest.mark.parametrize("strategy", ["tp", "fsdp"])
def test_make_rules_for_strategy(strategy):
    """``make_rules_for`` takes the FSDP table for ``sharding_strategy``
    fsdp, the default rules otherwise, as the reference does."""
    names = ("data", "model")
    mine = R.make_rules_for(
        dataclasses.replace(get_config("qwen2_0_5b"),
                            sharding_strategy=strategy), Mesh((2, 4), names))
    ref = JR.make_rules_for(
        dataclasses.replace(jax_config("qwen2_0_5b"),
                            sharding_strategy=strategy),
        types.SimpleNamespace(axis_names=names, devices=np.empty((2, 4))))
    assert mine.table == ref.table
    assert mine.table["ff"] == (() if strategy == "fsdp" else ("model",))
    assert mine.spec(("batch", "ff"), (8, 4864)) == tuple(
        ref.spec(("batch", "ff"), (8, 4864)))


def _jax_axes(arch, smoke):
    cfg = jax_config(arch)
    cfg = cfg.smoke() if smoke else cfg
    tree = jax.eval_shape(lambda k: japi.get_model(cfg).init(k, cfg),
                          jax.random.PRNGKey(0))
    return JL.split_params(tree)[1]


def _as_dicts(tree):
    if isinstance(tree, dict):
        return {k: _as_dicts(v) for k, v in tree.items()}
    return tuple(tree)


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_axes_match_reference(arch, smoke):
    """``api.param_axes`` is the reference's axes tree, and its W8A8
    mirror the reference's ``quantize_param_axes`` of it."""
    ref = _as_dicts(_jax_axes(arch, smoke))
    cfg = _cfg(arch, smoke)
    assert api.param_axes(cfg) == ref
    q = dataclasses.replace(cfg, quant=QuantConfig("w8a8"))
    assert api.param_axes(q) == _as_dicts(JR.quantize_param_axes(ref))
    assert R.quantize_param_axes(api.param_axes(q)) == api.param_axes(q)


def _split(full, spec, rules, rank):
    """``full``'s shard by ``np.split`` along each sharded dim."""
    coords = rules.mesh.coords(rank)
    out = full
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        names = ax if isinstance(ax, tuple) else (ax,)
        n, i = 1, 0
        for a in names:
            n *= rules.axis_sizes[a]
            i = i * rules.axis_sizes[a] + coords[a]
        out = np.split(out, n, axis=dim)[i]
    return out


def _np(t):
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 \
        else t.numpy()


@pytest.mark.parametrize("shape", [(1, 2), (1, 4), (1, 8), (2, 2)],
                         ids=["1x2", "1x4", "1x8", "2x2"])
@pytest.mark.parametrize("source", ["jax", "init_params", "w8a8"])
def test_shard_params_is_a_bitwise_slice(source, shape):
    """Each rank's tree is a bitwise slice of the single-device tree (JAX
    weights through ``params_from_jax``, an ``init_params`` draw in bf16,
    and the packed W8A8 tree); the shards tile the whole leaf."""
    cfg = get_config("qwen2_0_5b").smoke()
    if source == "jax":
        jp = japi.init_params(0, jax_config("qwen2_0_5b").smoke())[0]
        full = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    elif source == "init_params":
        cfg = dataclasses.replace(cfg, dtype="bfloat16")
        full = api.init_params(0, cfg, "cpu")
    else:
        cfg = dataclasses.replace(cfg, quant=QuantConfig("w8a8"))
        full = R.quantize_params(api.init_params(0, cfg, "cpu"))
    rules = R.Rules(Mesh(shape, ("data", "model")))
    axes = api.param_axes(cfg)
    shards = [shard_params(full, axes, rules, r) for r in range(np.prod(shape))]
    for path, leaf in _leaves(full):
        spec = rules.spec(_get(axes, path), tuple(leaf.shape))
        n = 1
        for r, tree in enumerate(shards):
            got = _get(tree, path)
            assert got.dtype == leaf.dtype and got.is_contiguous()
            want = _split(_np(leaf), spec, rules, r)
            assert _np(got).tobytes() == np.ascontiguousarray(want).tobytes()
        for ax in spec:
            n *= 1 if ax is None else rules.axis_sizes[ax]
        local = _get(shards[0], path).numel()
        assert local * n == leaf.numel(), path


@pytest.mark.parametrize("m", [1, 2, 3, 4, 7, 8, 14, 16])
@pytest.mark.parametrize("arch", ["qwen2_0_5b", "minitron_8b"])
def test_paged_tp_plan_matches_reference(arch, m):
    """The paged attention plan at each model-axis size: matched,
    replicated KV or heads replicated, as the reference decides it; and
    the local KV map of every rank is the reference's
    ``(s * Hloc + i) // g`` (``arange(Hloc) // g`` when matched)."""
    cfg = get_config(arch)
    ref, mine = _rules((1, m), ("data", "model"))
    plan = L._paged_tp_plan(mine, cfg.n_heads, cfg.n_kv_heads)
    assert plan == JL._paged_tp_plan(ref, cfg.n_heads, cfg.n_kv_heads)
    if plan is None:
        return
    g = cfg.n_heads // cfg.n_kv_heads
    hloc = cfg.n_heads // m
    for s in range(m):
        first = 0 if plan[1] else s * hloc
        got = L._kv_map(hloc, first, g, torch.device("cpu")).tolist()
        i = np.arange(hloc)
        want = (i // g if plan[1] else (s * hloc + i) // g).tolist()
        assert got == want


def test_qwen2_replicated_kv_groups_straddle():
    """qwen2_0_5b on a 7-way axis: each rank's two query heads read the
    replicated pool, rank 3's pair straddles KV heads 0 and 1, and KV
    head 1 is read by no head of ranks 0-2."""
    cfg = get_config("qwen2_0_5b")
    maps = [L._kv_map(2, s * 2, 7, torch.device("cpu")).tolist()
            for s in range(7)]
    assert maps == [[0, 0], [0, 0], [0, 0], [0, 1], [1, 1], [1, 1], [1, 1]]
    ref, mine = _rules((1, 7), ("data", "model"))
    assert L._paged_tp_plan(mine, cfg.n_heads, cfg.n_kv_heads) == (
        "model", False)


@pytest.mark.parametrize("m", [1, 2, 4, 7, 8])
@pytest.mark.parametrize("arch", ["qwen2_0_5b", "minitron_8b"])
def test_paged_pools_allocated_at_the_rank_shape(arch, m):
    """``PagedKVCache(rules=)`` allocates each pool at one rank's shard of
    the reference's ``PAGED_KV_AXES`` layout (pages whole, kv_heads cut
    where they divide the model axis), the shape the reference's
    ``jax.device_put`` gives a device; nothing whole is made first."""
    from repro.serve.kv_cache import PAGED_KV_AXES as JAXES
    from repro_torch.serve.kv_cache import PagedKVCache
    cfg = get_config(arch).smoke()
    ref, mine = _rules((1, m), ("data", "model"))
    cache = PagedKVCache(cfg, num_blocks=4, block_size=4, max_seq_len=8,
                         device="meta", rules=mine)
    whole = (cfg.n_layers, 4, 4, cfg.n_kv_heads, cfg.head_dim)
    for name, pool in cache.pools.items():
        spec = ref.spec(JAXES[name], whole)
        want = tuple(d // (1 if ax is None else m)
                     for d, ax in zip(whole, spec))
        assert tuple(pool.shape) == want, (name, spec)
