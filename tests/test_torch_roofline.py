"""The port's roofline (``repro_torch.roofline``) against the JAX
package's.

* FLOPs: the cost counter's product FLOPs of one meta run of a smoke
  train, prefill and decode step equal ``repro.roofline.hlo_cost``'s
  walker over the same step compiled on one CPU device with the reference
  backend (tolerance: exact). One term differs by design and is checked
  on its own: rwkv6's backward, where XLA forms the WKV's rank-1 outer
  product ``k_t v_t^T`` as a dot with no contracted dim (2 B H hd^2
  FLOPs a token a layer) and the port's autograd as an elementwise
  product. The walker's bytes count XLA's fusions, the counter's eager
  aten ops: they are not compared.
* The trip-count multiply equals the full loop on smoke cells: rwkv6's
  sequential and chunked WKV and the blocked attention, FLOPs, bytes and
  peak of a prefill; FLOPs of a train step.
* ``model_flops`` equals the reference's for every arch x shape; the
  H100 peaks, ``bound_s``, the byte rules, the registry's meta route and
  the breakdown.

``repro.launch.dryrun`` is not imported (it forces 512 host devices);
the reference steps are built here.
"""
import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs.base import SHAPES as JAX_SHAPES
from repro.configs.base import ShapeConfig as JaxShape
from repro.configs.base import get_config as jax_config
from repro.models import api as japi
from repro.models.layers import split_params
from repro.roofline.analysis import model_flops as jax_model_flops
from repro.roofline.hlo_cost import analyze_text
from repro.train.optimizer import OptConfig as JaxOpt
from repro.train.optimizer import adamw_update, init_opt_state
from repro_torch import ops
from repro_torch.configs.base import ARCH_NAMES, SHAPES, ShapeConfig, get_config
from repro_torch.kernels import flash_e2softmax as KA
from repro_torch.launch import dryrun as D
from repro_torch.roofline import analysis as RA
from repro_torch.roofline import cost as C
from repro_torch.roofline.breakdown import breakdown
from repro_torch.roofline.breakdown import main as breakdown_main

SMOKE = (64, 2)                      # (seq_len, global_batch) of a cell
KINDS = ("train", "prefill", "decode")


def _jax_flops(arch, kind):
    """The walker's FLOPs of the reference's step for the smoke cell,
    built as ``repro/launch/dryrun.py`` builds it on one device."""
    jcfg = dataclasses.replace(jax_config(arch).smoke(),
                               ops_backend="reference")
    shape = JaxShape("smoke", *SMOKE, kind)
    m = japi.get_model(jcfg)
    params, _ = split_params(jax.eval_shape(
        lambda k: m.init(k, jcfg), jax.ShapeDtypeStruct((2,), jnp.uint32)))
    if kind == "train":
        def step(p, o, b):
            (_, _), g = jax.value_and_grad(japi.loss_fn, has_aux=True)(
                p, b, jcfg)
            return adamw_update(p, g, o, JaxOpt())
        args = (params, jax.eval_shape(init_opt_state, params),
                japi.train_inputs(jcfg, shape)[0])
    else:
        params = jax.tree.map(lambda t: jax.ShapeDtypeStruct(
            t.shape, jnp.dtype(jcfg.dtype) if t.dtype == jnp.float32
            else t.dtype), params)
        if kind == "prefill":
            batch, _ = japi.prefill_inputs(jcfg, shape)
            tok = jcfg.family in ("encdec", "vlm")

            def step(p, b):
                return m.prefill(p, b if tok else b["tokens"], jcfg,
                                 shape.seq_len)
            args = (params, batch)
        else:
            cache, _, token, pos = japi.decode_inputs(jcfg, shape)

            def step(p, c, t, i):
                return m.decode_step(p, c, t, i, jcfg)
            args = (params, cache, token, pos)
    return analyze_text(jax.jit(step).lower(*args).compile().as_text()).flops


def _port_cost(cfg, kind, unroll=False):
    shape = ShapeConfig("smoke", *SMOKE, kind)
    thunk, parts = {"train": D.train_cell, "prefill": D.prefill_cell,
                    "decode": D.decode_cell}[kind](cfg, shape)
    counter = C.CostCounter(unroll=unroll)
    with counter:
        for tree in parts.values():
            counter.resident(tree)
        if kind == "train":
            thunk()
        else:
            with torch.no_grad():
                thunk()
    return counter.cost


# train cells: one config per family (a train step's compile dominates)
FAMILY_ARCHS = ("qwen2_0_5b", "mixtral_8x7b", "rwkv6_7b",
                "recurrentgemma_9b", "whisper_small", "qwen2_vl_7b")
FLOP_CELLS = [(a, k) for a in ARCH_NAMES for k in KINDS
              if k != "train" or a in FAMILY_ARCHS]


@pytest.mark.parametrize("arch,kind", FLOP_CELLS)
def test_product_flops_match_hlo_walker(arch, kind):
    cfg = get_config(arch).smoke()
    port = _port_cost(cfg, kind).product_flops
    ref = _jax_flops(arch, kind)
    if arch == "rwkv6_7b" and kind == "train":
        b, (s, _) = SMOKE[1], SMOKE
        h, hd = cfg.d_model // cfg.rwkv_head_size, cfg.rwkv_head_size
        assert ref - port == 2 * b * h * hd * hd * s * cfg.n_layers
    else:
        assert port == ref


def _same(a, b):
    return (a.flops_by_type, a.bytes, a.peak_bytes, a.kernel_bytes) == \
        (b.flops_by_type, b.bytes, b.peak_bytes, b.kernel_bytes)


@pytest.mark.parametrize("over", [dict(arch="rwkv6_7b"),
                                  dict(arch="rwkv6_7b", rwkv_chunk=16),
                                  dict(arch="qwen2_0_5b", attn_impl="blocked")])
def test_trip_count_multiply_equals_full_loop(over):
    over = dict(over)
    cfg = dataclasses.replace(get_config(over.pop("arch")).smoke(), **over)
    tripped = _port_cost(cfg, "prefill")
    full = _port_cost(cfg, "prefill", unroll=True)
    assert _same(tripped, full)
    if "rwkv_chunk" not in over:     # the chunks' backward: see docstring
        assert (_port_cost(cfg, "train").product_flops
                == _port_cost(cfg, "train", unroll=True).product_flops)


def test_trips_runs_two_trips_on_meta_only():
    seen = []
    a, b = (torch.empty(3, device="meta") for _ in range(2))
    with C.CostCounter(), torch.no_grad():
        loop = C.Trips(5, "meta")
        seen.append(list(loop))
        seen.append(list(C.Trips(5, "cpu")))
        kept = loop.kept([a, b])
    seen.append(list(C.Trips(5, "meta")))        # no counter in force
    assert seen == [[0, 1], [0, 1, 2, 3, 4], [0, 1, 2, 3, 4]]
    assert kept == [a, b, b, b, b]


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_model_flops_match_reference(arch):
    for name, sh in SHAPES.items():
        assert RA.model_flops(get_config(arch), sh) == jax_model_flops(
            jax_config(arch), JAX_SHAPES[name])


def test_h100_peaks_and_bound():
    assert RA.HBM_BW == 3.35e12
    assert RA.PEAK_FLOPS == {"bfloat16": 989e12, "float32": 67e12,
                             "int8": 1979e12}
    assert RA.bound_s(3.35e12, {"bfloat16": 1e12}) == (1.0, "bytes")
    t, by = RA.bound_s(1.0, {"bfloat16": 989e12, "float32": 67e12})
    assert (t, by) == (2.0, "operations")
    cost = C.Cost(flops_by_type={"bfloat16": 989e12, "int8": 1979e12},
                  bytes=3.35e12)
    roof = RA.make_roofline(get_config("qwen2_0_5b"), SHAPES["decode_32k"],
                            "single", 1, cost)
    assert roof.compute_s == 2.0 and roof.memory_s == 1.0
    assert roof.bound_s == 2.0 and roof.dominant == "compute"
    assert roof.collective_s == 0.0
    assert roof.useful_ratio == roof.model_flops / cost.flops
    assert roof.roofline_fraction == pytest.approx(
        roof.model_flops / 989e12 / 2.0)


def test_byte_and_flop_rules():
    """Views free, allocation free, products typed, gathers and in-place
    index updates by the rows they move, peak from storage lifetimes."""
    counter = C.CostCounter()
    bf = torch.bfloat16
    with counter:
        a = torch.empty((64, 32), dtype=bf, device="meta")
        w = torch.empty((32, 16), dtype=bf, device="meta")
        assert counter.cost.bytes == 0                      # empty: free
        a.view(32, 64).t().reshape(64, 32)                  # views: free
        assert counter.cost.bytes == 0
        y = a @ w                                           # 64x16 bf16
        assert counter.cost.flops_by_type == {"bfloat16": 2 * 64 * 32 * 16}
        assert counter.cost.bytes == (64 * 32 + 32 * 16 + 64 * 16) * 2
        before = counter.cost.bytes
        idx = torch.empty(4, dtype=torch.long, device="meta")
        rows = a[idx]                                       # gather 4 rows
        assert counter.cost.bytes - before == 2 * 4 * 32 * 2 + 4 * 8
        before = counter.cost.bytes
        a.index_put_((idx,), rows)                          # update 4 rows
        assert counter.cost.bytes - before == 2 * 4 * 32 * 2 + 4 * 8
        live = counter.live_bytes
        del y, rows
        assert counter.live_bytes == live - 2048 - 512
    assert counter.cost.peak_bytes == 4096 + 1024 + 2048 + 512 + 512
    assert counter.cost.product_flops == 2 * 64 * 32 * 16
    assert counter.cost.kernel_flops == 0


def test_registry_routes_meta_through_the_kernels():
    """On meta a pair with a kernel reaches its wrapper, which writes the
    kernel's output and reports the work of ``chip_smoke.py``'s bound,
    launching nothing; pairs without one run their torch ops."""
    assert ops.backend_for("paged_attention", "sole", "meta") == "cuda"
    assert ops.backend_for("softmax", "exact", "meta") == "reference"
    assert ops.backend_for("rmsnorm", "sole", "meta", "reference") == \
        "reference"
    assert ops.backend_for("rmsnorm", "sole", "meta", "cuda") == "cuda"
    b, h, c, d, kvh, bs, nb = 2, 4, 3, 16, 2, 8, 5
    meta = {"device": "meta"}
    q = torch.empty((b, h, c, d), dtype=torch.bfloat16, **meta)
    pool = torch.empty((b * nb + 1, bs, kvh, d), dtype=torch.bfloat16, **meta)
    tables = torch.empty((b, nb), dtype=torch.int32, **meta)
    lens = torch.empty((b, 2), dtype=torch.int32, **meta)
    launches = KA.flash_e2softmax_paged.launches
    counter = C.CostCounter()
    with counter:
        out = KA.flash_e2softmax_paged(q, pool, pool, tables, lens,
                                       causal=True)
    assert out.is_meta and out.shape == (b, h, c, d)
    assert out.dtype == torch.float32
    assert KA.flash_e2softmax_paged.launches == launches
    moved, flops = C.paged_attention_work(
        (b, h, c, d), 2, 2, [(nb * bs - c, nb * bs)] * b, causal=True,
        kv_heads=kvh)
    rec = counter.records[("kernel:paged_e2softmax", str((b, h, c, d)))]
    assert rec == [1, moved, flops]
    assert counter.cost.flops_by_type == {"bfloat16": flops}


def test_breakdown_of_a_cell(capsys):
    counter, _ = D.count_cell(get_config("qwen2_0_5b").smoke(),
                              ShapeConfig("smoke", *SMOKE, "decode"),
                              paged=True)
    text = breakdown(counter.records, "bytes", 5)
    assert text.startswith("total bytes:") and len(text.splitlines()) == 6
    assert "kernel:paged_e2softmax" in breakdown(counter.records, "bytes",
                                                 100)
    assert breakdown(counter.records, "coll") == "total coll: 0.0000e+00"
    out = breakdown_main(["--arch", "qwen2_0_5b", "--shape", "decode_32k",
                          "--metric", "flops", "--top", "3", "--paged"])
    assert out.startswith("total flops:") and "aten.mm" in out
