"""The port's dry run (``repro_torch.launch.dryrun``) and ``models.api``'s
input builders against the JAX package, allocating nothing on either side
(``jax.eval_shape`` there, meta tensors here).

* The builders' trees equal the reference's ``ShapeDtypeStruct``s, shape,
  dtype and logical axes, for all 10 archs x 4 ``SHAPES`` (the hybrid's
  dense cache keeps its position as a host int where the reference has an
  int32 scalar: compared as one).
* At full width the parameter and optimizer bytes equal the reference's
  ``eval_shape`` trees: float32 masters and AdamW moments for training,
  serving parameters cast as ``repro/launch/dryrun.py:50-61`` casts them.
* ``param_count``/``active_param_count`` equal for every config and smoke.
* Every smoke cell, dense and paged, counts on meta with no error.

``repro.launch.dryrun`` is not imported: it forces 512 host devices at
import. Its reference steps are rebuilt in ``test_torch_roofline.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs.base import ARCH_NAMES as JAX_ARCHS
from repro.configs.base import SHAPES as JAX_SHAPES
from repro.configs.base import get_config as jax_config
from repro.models import api as japi
from repro.models.layers import split_params
from repro.train.optimizer import init_opt_state as jax_opt_state
from repro_torch.configs.base import ARCH_NAMES, SHAPES, ShapeConfig, get_config
from repro_torch.launch import dryrun as D
from repro_torch.models import api
from repro_torch.roofline.analysis import CARD_BYTES
from repro_torch.roofline.report import main as report_main

CELLS = [(a, s) for a in ARCH_NAMES for s in SHAPES]
SMOKE_SHAPES = (ShapeConfig("smoke_train", 64, 2, "train"),
                ShapeConfig("smoke_prefill", 64, 2, "prefill"),
                ShapeConfig("smoke_decode", 64, 2, "decode"))


def _flat(tree, pre=""):
    """{path: leaf} of nested dicts (tuples of axes are leaves)."""
    if isinstance(tree, dict):
        out = {}
        for k in tree:
            out.update(_flat(tree[k], f"{pre}/{k}"))
        return out
    return {pre: tree}


def _sig(leaf):
    """(shape, dtype name) of a ShapeDtypeStruct, tensor or host int."""
    if isinstance(leaf, int):
        return (), "int32"
    return tuple(leaf.shape), str(leaf.dtype).replace("torch.", "")


def _same_specs(ref, port):
    r, p = _flat(ref), _flat(port)
    assert set(r) == set(p)
    assert {k: _sig(v) for k, v in r.items()} == \
        {k: _sig(v) for k, v in p.items()}


def _same_axes(ref, port):
    assert {k: tuple(v) for k, v in _flat(ref).items()} == \
        {k: tuple(v) for k, v in _flat(port).items()}


def test_the_port_has_every_reference_arch():
    assert set(ARCH_NAMES) == set(JAX_ARCHS)
    assert {k: (v.seq_len, v.global_batch, v.kind)
            for k, v in SHAPES.items()} == \
        {k: (v.seq_len, v.global_batch, v.kind)
         for k, v in JAX_SHAPES.items()}


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_builders_match_reference(arch, shape):
    jcfg, cfg = jax_config(arch), get_config(arch)
    jsh, sh = JAX_SHAPES[shape], SHAPES[shape]
    for name in ("train_inputs", "prefill_inputs"):
        jb, jax_ax = getattr(japi, name)(jcfg, jsh)
        b, ax = getattr(api, name)(cfg, sh)
        _same_specs(jb, b)
        _same_axes(jax_ax, ax)
        assert all(t.is_meta for t in _flat(b).values())
    jc, jcax, jtok, jpos = japi.decode_inputs(jcfg, jsh)
    c, cax, tok, pos = api.decode_inputs(cfg, sh)
    _same_specs({"c": jc, "t": jtok, "p": jpos},
                {"c": c, "t": tok, "p": pos})
    _same_axes(jcax, cax)
    if not api.sequence_state_spec(cfg).servable:
        with pytest.raises(ValueError, match="not paged-servable"):
            japi.paged_decode_inputs(jcfg, jsh)
        with pytest.raises(ValueError, match="not paged-servable"):
            api.paged_decode_inputs(cfg, sh)
        return
    jst, jsax, jtok, jpos, jrefs = japi.paged_decode_inputs(jcfg, jsh)
    st, sax, tok, pos, refs = api.paged_decode_inputs(cfg, sh)
    _same_specs({"s": jst, "t": jtok, "p": jpos, "r": jrefs},
                {"s": st, "t": tok, "p": pos, "r": refs})
    _same_axes(jsax, sax)


def _bytes(tree):
    return sum(l.size * l.dtype.itemsize for l in jax.tree.leaves(tree))


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_and_optimizer_bytes_match_reference(arch):
    """Full width: the reference's ``eval_shape`` trees, the serving ones
    cast as its dry run casts them, against the port's meta trees."""
    jcfg, cfg = jax_config(arch), get_config(arch)
    m = japi.get_model(jcfg)
    p_sds, _ = split_params(jax.eval_shape(
        lambda k: m.init(k, jcfg), jax.ShapeDtypeStruct((2,), jnp.uint32)))
    opt = jax.eval_shape(jax_opt_state, p_sds)
    serve = jax.tree.map(lambda t: jax.ShapeDtypeStruct(
        t.shape, jnp.dtype(jcfg.dtype) if t.dtype == jnp.float32
        else t.dtype), p_sds)
    masters = api.init_params(0, cfg, "meta", masters=True)
    assert D.tree_bytes(masters) == _bytes(p_sds)
    assert D.tree_bytes(D.serve_params(cfg)) == _bytes(serve)
    from repro_torch.train.optimizer import init_opt_state
    assert D.tree_bytes(init_opt_state(masters)) == _bytes(opt)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_counts_match_reference(arch):
    for jcfg, cfg in ((jax_config(arch), get_config(arch)),
                      (jax_config(arch).smoke(), get_config(arch).smoke())):
        assert cfg.param_count() == jcfg.param_count()
        assert cfg.active_param_count() == jcfg.active_param_count()


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_every_smoke_cell_counts_on_meta(arch):
    """Train, prefill, dense decode and (servable families) paged decode
    of the smoke config: the step runs on meta, the kernels' work is
    counted, bytes and a peak above the resident bytes come out."""
    cfg = get_config(arch).smoke()
    paged_ok = api.sequence_state_spec(cfg).servable
    for sh in SMOKE_SHAPES:
        for paged in ((False, True) if sh.kind == "decode" and paged_ok
                      else (False,)):
            counter, parts = D.count_cell(cfg, sh, paged=paged)
            cost = counter.cost
            assert cost.flops > 0 and cost.bytes > 0
            assert cost.peak_bytes >= sum(parts.values())
            assert cost.resident_bytes >= sum(parts.values())
            assert cost.coll_bytes == 0
            if sh.kind != "train":       # SOLE serving runs the kernels
                assert cost.kernel_bytes > 0


def test_run_cell_records_statuses(tmp_path):
    """ok, skipped (the config's skip_shapes with the reference's reason;
    a family that is not paged-servable), and an error recorded loudly."""
    ok = D.run_cell("qwen2_0_5b", "decode_32k", out_dir=str(tmp_path))
    assert ok["status"] == "ok" and ok["dominant"] == "memory"
    assert ok["memory"]["card_bytes"] == CARD_BYTES
    assert ok["memory"]["fits_one_card"] == (
        ok["memory"]["peak_bytes"] < CARD_BYTES)
    assert ok["bound_s"] == max(ok["compute_s"], ok["memory_s"])
    skip = D.run_cell("qwen2_0_5b", "long_500k", out_dir=str(tmp_path))
    assert skip["status"] == "skipped" and "sub-quadratic" in skip["reason"]
    vlm = D.run_cell("qwen2_vl_7b", "decode_32k", out_dir=str(tmp_path),
                     paged=True)
    assert vlm["status"] == "skipped" and "paged-servable" in vlm["reason"]
    bad = D.run_cell("qwen2_0_5b", "decode_32k", out_dir=str(tmp_path),
                     overrides={"ops_backend": "nope"}, tag="bad")
    assert bad["status"] == "error" and "nope" in bad["error"]
    assert "Traceback" in bad["traceback"]
    assert len(list(tmp_path.glob("*.json"))) == 4
    text = report_main([str(tmp_path)])
    assert "| qwen2_0_5b | decode_32k | ok |" in text
    assert "qwen2_0_5b+bad" in text.split("## Cells in error")[1]


def test_cli_overrides_and_mesh(tmp_path, capsys):
    rows = D.main(["--arch", "qwen2_0_5b", "--shape", "decode_32k",
                   "--set", "kv_cache_dtype=int8", "--tag", "kv8",
                   "--paged", "--out", str(tmp_path)])
    assert [r["status"] for r in rows] == ["ok"]
    assert rows[0]["arch"] == "qwen2_0_5b+paged+kv8"
    assert rows[0]["overrides"] == {"kv_cache_dtype": "int8"}
    assert "[     ok] qwen2_0_5b" in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="item 9"):
        D.main(["--arch", "qwen2_0_5b", "--mesh", "multi",
                "--out", str(tmp_path)])
