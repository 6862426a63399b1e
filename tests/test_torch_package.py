"""Package-level guarantees of the PyTorch/CUDA port (``src/repro_torch``).

* Its configs are a copy of the JAX package's, held field-for-field equal
  here (the port may not import ``repro.configs``).
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

from repro.configs.base import ArchConfig as JaxArchConfig
from repro.configs.base import QuantConfig as JaxQuantConfig
from repro.configs.base import get_config as jax_config
from repro.models import api as japi
from repro.models.layers import shapes_of
from repro_torch.configs.base import ARCH_NAMES, ArchConfig, QuantConfig
from repro_torch.configs.base import get_config
from repro_torch.kernels import ailayernorm as KN
from repro_torch.kernels import build
from repro_torch.kernels import flash_e2softmax as KA
from repro_torch.kernels import int8_matmul as KM
from repro_torch import ops as tops
from repro_torch.models import api
from repro_torch.serve.engine import PagedEngine, Request

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "repro")


def _fields(cls):
    # repr: the two QuantConfig() defaults are instances of two classes
    return [(f.name, repr(f.default)) for f in dataclasses.fields(cls)]


def test_config_classes_match_reference():
    """Same fields, in the same order, with the same defaults."""
    assert _fields(ArchConfig) == _fields(JaxArchConfig)
    assert _fields(QuantConfig) == _fields(JaxQuantConfig)
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
                "core/baselines/ibert.py", "core/baselines/softermax.py"):
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
    the reference's scales (0.02, the head d_model^-0.5)."""
    cfg = dataclasses.replace(get_config(name).smoke(), dtype="float32")
    params = api.init_params(0, cfg, "cpu")
    want = shapes_of(japi.init_params(0, jax_config(name).smoke())[0])
    got = {k: v for k, v in _shapes(params).items()}
    assert got == _flat(want)
    layers = params["layers"]
    assert torch.equal(layers["ln1"]["g"], torch.ones_like(layers["ln1"]["g"]))
    if cfg.qkv_bias:
        assert not layers["attn"]["bq"].any()
    for leaf, scale in ((layers["mlp"]["up"], 0.02),
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
    (dict(family="moe"), NotImplementedError, "ROADMAP"),
    (dict(family="moe", quant=QuantConfig("w8a8")), NotImplementedError,
     "ROADMAP"),
    (dict(family="ssm", quant=QuantConfig("w8a8")), ValueError,
     "no quantized serving path"),
    (dict(family="hybrid", quant=QuantConfig("w8a16")), ValueError,
     "no quantized serving path")])
def test_engine_raises_for_unported_config(change, err, match):
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


@pytest.mark.parametrize("kw", [dict(spec_config=object()),
                                dict(rules=object())])
def test_engine_raises_for_unported_features(kw):
    cfg, params = _smoke_engine_args()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        PagedEngine(cfg, params, device="cpu", **kw)


def test_missing_nvcc_raises(monkeypatch):
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build, "NVCC_DEFAULT", os.path.join(REPO, "no-nvcc"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc_path()


def test_wrappers_take_only_cpu_or_cuda_tensors():
    """A tensor on any other device raises: nothing is computed with the
    plain version unless the tensor lies on the CPU."""
    q = torch.zeros((1, 2, 1, 8), device="meta")
    pool = torch.zeros((3, 4, 1, 8), device="meta")
    tables = torch.zeros((1, 2), dtype=torch.int32, device="meta")
    meta = torch.zeros((1, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no paged_e2softmax"):
        KA.flash_e2softmax_paged(q, pool, pool, tables, meta)
    x = torch.zeros((2, 8), device="meta")
    with pytest.raises(ValueError, match="no ailayernorm kernel"):
        KN.qnorm(x, x[0], x[0].int(), x[0], x[0], rms=True)
    a = torch.zeros((2, 8), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="no int8_matmul kernel"):
        KM.int8_matmul(a, a.t().contiguous())
