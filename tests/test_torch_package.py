"""Package-level guarantees of the PyTorch/CUDA port (``src/repro_torch``).

* Its configs are a copy of the JAX package's, held field-for-field equal
  here (the port may not import ``repro.configs``): the architectures,
  the shapes (``ShapeConfig``, ``SHAPES``) and the optimizer's
  ``OptConfig``.
* Neither the package nor ``chip_smoke.py`` imports ``jax``/``jaxlib`` or
  anything of ``repro`` (an AST scan of every import statement and every
  ``importlib.import_module`` call).
* Random init has the reference's tree, shapes and scales.
* ``PagedEngine`` never runs on the CPU unless asked to, and features the
  port does not have yet raise instead of being downgraded; quantized
  serving packs only float32 masters and only for the dense family.
* A missing ``nvcc`` raises; the kernel wrappers take no device other than
  the CPU (plain version) and CUDA (the kernel).
"""
import ast
import dataclasses
import os

import numpy as np
import pytest
import torch

from repro.configs.base import SHAPES as JAX_SHAPES
from repro.configs.base import ArchConfig as JaxArchConfig
from repro.configs.base import QuantConfig as JaxQuantConfig
from repro.configs.base import ShapeConfig as JaxShapeConfig
from repro.configs.base import get_config as jax_config
from repro.models import api as japi
from repro.models.layers import shapes_of
from repro.train.optimizer import OptConfig as JaxOptConfig
from repro_torch.configs.base import (ARCH_NAMES, SHAPES, ArchConfig,
                                      QuantConfig, ShapeConfig)
from repro_torch.configs.base import get_config
from repro_torch.kernels import ailayernorm as KN
from repro_torch.kernels import build
from repro_torch.kernels import flash_e2softmax as KA
from repro_torch.kernels import int8_matmul as KM
from repro_torch import ops as tops
from repro_torch.models import api
from repro_torch.roofline.cost import CostCounter
from repro_torch.serve.engine import PagedEngine, Request
from repro_torch.train.optimizer import OptConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "repro")


def _fields(cls):
    # repr: the two QuantConfig() defaults are instances of two classes
    return [(f.name, repr(f.default)) for f in dataclasses.fields(cls)]


def test_config_classes_match_reference():
    """Same fields, in the same order, with the same defaults."""
    assert _fields(ArchConfig) == _fields(JaxArchConfig)
    assert _fields(QuantConfig) == _fields(JaxQuantConfig)
    assert _fields(ShapeConfig) == _fields(JaxShapeConfig)
    assert _fields(OptConfig) == _fields(JaxOptConfig)
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in JAX_SHAPES.items()}
    for mode in ("off", "w8a16", "w8a8"):
        t, j = QuantConfig(mode), JaxQuantConfig(mode)
        assert (t.weights, t.acts) == (j.weights, j.acts)


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_config_copies_equal_reference(name):
    t, j = get_config(name), jax_config(name)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(t.smoke()) == dataclasses.asdict(j.smoke())
    assert t.padded_vocab == j.padded_vocab and t.head_dim == j.head_dim


def test_unported_architecture_raises():
    with pytest.raises(ValueError, match="not ported"):
        get_config("llama3_8b")


def _port_sources():
    root = os.path.join(REPO, "src", "repro_torch")
    for d, _, files in os.walk(root):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(REPO, "chip_smoke.py")


def _imported_modules(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield "." * node.level + (node.module or "")
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args):
            arg = node.args[0]
            if isinstance(arg, ast.Constant):
                yield str(arg.value)
            elif isinstance(arg, ast.JoinedStr):
                yield "".join(str(v.value) for v in arg.values
                              if isinstance(v, ast.Constant))


def test_port_imports_no_jax_and_nothing_of_repro():
    paths = list(_port_sources())
    assert len(paths) > 20
    scanned = {os.path.relpath(p, REPO) for p in paths}
    for mod in ("kernels/int8_matmul.py", "sharding/rules.py",
                "sharding/__init__.py", "core/sole/quant.py", "ops/cuda.py",
                "kernels/e2softmax.py", "launch/__init__.py",
                "launch/serve.py", "launch/quickstart.py", "ops/oracles.py",
                "core/baselines/ibert.py", "core/baselines/softermax.py",
                "data/pipeline.py", "data/__init__.py", "train/__init__.py",
                "train/optimizer.py", "train/checkpoint.py",
                "train/elastic.py", "train/trainer.py", "launch/train.py",
                "launch/train_then_serve.py"):
        assert os.path.join("src", "repro_torch", mod) in scanned
    bad = [(os.path.relpath(p, REPO), m) for p in paths
           for m in _imported_modules(p)
           if m.split(".")[0] in FORBIDDEN]
    assert bad == []


def test_import_scan_sees_every_kind_of_import(tmp_path):
    src = tmp_path / "x.py"
    src.write_text("import jax.numpy\nfrom repro.ops import resolve\n"
                   "import importlib\nimportlib.import_module(f'repro.{x}')\n"
                   "import repro_torch\n")
    assert sorted(m.split(".")[0] for m in _imported_modules(str(src))) == [
        "importlib", "jax", "repro", "repro", "repro_torch"]


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_init_params_tree_matches_reference(name):
    """Same leaves and shapes; norms ones/zeros, biases zero, weights at
    the reference's scales (0.02, the head d_model^-0.5); the recurrent
    families' constants (rwkv6's ``w0`` -6, the RG-LRU's ``lam`` 0.7, ``ba``
    2) in the dtype the reference computes them in."""
    cfg = dataclasses.replace(get_config(name).smoke(), dtype="float32")
    params = api.init_params(0, cfg, "cpu")
    want = shapes_of(japi.init_params(0, jax_config(name).smoke())[0])
    got = {k: v for k, v in _shapes(params).items()}
    assert got == _flat(want)
    layers = (params.get("layers") or params.get("dec_layers")
              or params["tail"])
    norm = layers["ln1"] if "ln1" in layers else layers["ln"]
    assert torch.equal(norm["g"], torch.ones_like(norm["g"]))
    if cfg.family == "ssm":
        assert (layers["tm"]["w0"] == -6.0).all()
        assert layers["tm"]["w0"].dtype == torch.float32
        assert torch.equal(layers["tm"]["gn_g"],
                           torch.ones_like(layers["tm"]["gn_g"]))
        ffn = layers["cm"]["wk"]
    else:
        ffn = layers["mlp"]["up"]
    if cfg.family == "hybrid":
        assert (layers["lam"] == 0.7).all() and (layers["ba"] == 2.0).all()
        assert layers["lam"].dtype == torch.float32
    if cfg.qkv_bias:
        assert not layers["attn"]["bq"].any()
    for leaf, scale in ((ffn, 0.02),
                        (params["embed"]["head"], cfg.d_model ** -0.5)):
        assert abs(leaf.std().item() / scale - 1) < 0.1
    again = api.init_params(0, cfg, "cpu")
    assert torch.equal(again["embed"]["table"], params["embed"]["table"])


def _shapes(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_shapes(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = tuple(v.shape)
    return out


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = tuple(v)
    return out


def _smoke_engine_args():
    cfg = get_config("qwen2_0_5b").smoke()
    return cfg, api.init_params(0, cfg, "cpu")


def test_engine_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    cfg, params = _smoke_engine_args()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PagedEngine(cfg, params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PagedEngine(cfg, params, device="cuda")
    eng = PagedEngine(cfg, params, device="cpu", num_blocks=8, block_size=8,
                      max_seq_len=32, decode_batch=2, prefill_chunk=8)
    out = eng.generate([Request(prompt=np.arange(5, dtype=np.int32),
                                max_new_tokens=3)])
    assert len(out[0]) == 3
    eng.cache.check_refcounts()


@pytest.mark.parametrize("change,err,match", [
    (dict(family="encdec"), ValueError, "needs encoder frames"),
    (dict(family="moe", quant=QuantConfig("w8a8")), NotImplementedError,
     "no quantized MoE path"),
    (dict(family="ssm", quant=QuantConfig("w8a8")), ValueError,
     "no quantized serving path"),
    (dict(family="hybrid", quant=QuantConfig("w8a16")), ValueError,
     "no quantized serving path")])
def test_engine_raises_for_unported_config(change, err, match):
    """Configurations the engine refuses; encdec is served but, as in the
    reference, every request must carry encoder frames."""
    if change.get("family") == "encdec":
        cfg = get_config("whisper_small").smoke()
        eng = PagedEngine(cfg, api.init_params(0, cfg, "cpu"), device="cpu")
        with pytest.raises(err, match=match):
            eng.submit(Request(prompt=np.arange(5, dtype=np.int32)))
        return
    cfg, params = _smoke_engine_args()
    with pytest.raises(err, match=match):
        PagedEngine(dataclasses.replace(cfg, **change), params, device="cpu")


def test_quantized_engine_packs_only_float32_masters():
    """init keeps float32 masters under quant.weights and the engine packs
    them; a bf16 projection (a lossy copy) is refused, not packed."""
    cfg = dataclasses.replace(get_config("qwen2_0_5b").smoke(),
                              dtype="bfloat16", quant=QuantConfig("w8a8"))
    params = api.init_params(0, cfg, "cpu")
    assert params["layers"]["attn"]["wq"].dtype == torch.float32
    assert params["embed"]["table"].dtype == torch.bfloat16
    eng = PagedEngine(cfg, params, device="cpu")
    assert eng.params["embed"]["head"]["q"].dtype == torch.int8
    assert set(eng.params["layers"]["mlp"]["down"]) == {"q", "s"}
    params["layers"]["attn"]["wq"] = params["layers"]["attn"]["wq"].bfloat16()
    with pytest.raises(ValueError, match="float32 masters"):
        PagedEngine(cfg, params, device="cpu")


@pytest.mark.parametrize("kind", ["layernorm", "rmsnorm"])
@pytest.mark.parametrize("quant_out", [True, False])
def test_static_norm_params_raise_on_the_cuda_backend(kind, quant_out):
    """Static params that are not ``PTFQuantParams`` raise from the cuda
    adapters instead of being ignored (the fused kernels take only PTF
    params; ``tests/test_torch_fused_norm.py`` holds the real ones)."""
    op = f"residual_{kind}_q" if quant_out else f"residual_{kind}"
    fn = tops.resolve(op, "sole", "cuda")
    x = torch.zeros((2, 8))
    with pytest.raises(TypeError, match="PTFQuantParams"):
        fn(x, x, torch.ones(8), torch.zeros(8), params=object())


def _data_axis_rules():
    from repro_torch.launch.mesh import Mesh, make_rules
    return make_rules(Mesh((2, 1), ("data", "model")))


@pytest.mark.parametrize("kw", [dict(cfg=dict(family="vlm")),
                                dict(rules=_data_axis_rules())])
def test_engine_raises_for_unported_features(kw):
    """The vlm family is not paged-servable (the reference's ``ValueError``)
    and mesh rules of more ranks than the process group holds raise (the
    (D, M) paths are ported: ``tests/test_torch_mesh_serve.py``,
    ``tests/test_torch_mesh_data.py``; speculative decoding:
    ``tests/test_torch_spec.py``)."""
    cfg, params = _smoke_engine_args()
    kw = dict(kw)
    change = kw.pop("cfg", {})
    cfg = dataclasses.replace(cfg, **change)
    err, match = ((ValueError, "not paged-servable") if change
                  else (ValueError, "in a process group of 1"))
    with pytest.raises(err, match=match):
        PagedEngine(cfg, params, device="cpu", **kw)


def test_missing_nvcc_raises(monkeypatch):
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build, "NVCC_DEFAULT", os.path.join(REPO, "no-nvcc"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc_path()


def _kernel_only(name, fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` on meta tensors under a cost counter: it
    reports one launch of kernel ``name``, and no aten op moves a byte or
    multiplies (the plain version did not run)."""
    with CostCounter() as counter:
        out = fn(*args, **kwargs)
    kernels = {k[0]: v[0] for k, v in counter.records.items()
               if k[0].startswith("kernel:")}
    assert kernels == {"kernel:" + name: 1}
    assert not [k for k, v in counter.records.items()
                if not k[0].startswith("kernel:") and (v[1] or v[2])]
    return out


def test_wrappers_take_only_cpu_or_cuda_tensors():
    """Nothing is computed with the plain version unless the tensor lies
    on the CPU: meta tensors (the dry run's) take the card's route, where
    each wrapper returns the kernel's outputs, shapes and dtypes, and
    neither launches nor computes anything."""
    q = torch.zeros((1, 2, 1, 8), device="meta")
    pool = torch.zeros((3, 4, 1, 8), device="meta")
    tables = torch.zeros((1, 2), dtype=torch.int32, device="meta")
    meta = torch.zeros((1, 2), dtype=torch.int32, device="meta")
    counts = (KA.flash_e2softmax_paged.launches, KN.qnorm.launches,
              KM.int8_matmul.launches)
    heads = KA.default_kv_head_map(2, 1, "meta")    # an input, made outside
    out = _kernel_only("paged_e2softmax", KA.flash_e2softmax_paged, q, pool,
                       pool, tables, meta, kv_head_map=heads)
    assert out.is_meta and out.shape == q.shape and out.dtype == torch.float32
    x = torch.zeros((2, 8), device="meta")
    out = _kernel_only("ailayernorm_qnorm", KN.qnorm, x, x[0, :1],
                       x[0].int(), x[0], x[0], rms=True)
    assert out.is_meta and out.shape == (2, 8)
    a = torch.zeros((2, 8), dtype=torch.int8, device="meta")
    w = a.t().contiguous()
    out = _kernel_only("int8_matmul", KM.int8_matmul, a, w)
    assert out.is_meta and out.shape == (2, 2) and out.dtype == torch.int32
    assert counts == (KA.flash_e2softmax_paged.launches, KN.qnorm.launches,
                      KM.int8_matmul.launches)
