"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX
package's ``repro.models.moe`` on the same numpy-seeded activations and
the same ``init_params`` weights (converted through numpy by
``params_from_jax``), and the MoE configs' weights and model entries.

The reference runs jitted, as its engines do (inside ``jit`` XLA keeps
the router's bf16 product in float32). Tolerances, relative to the
largest output:

* float32: 1e-6 (the router and expert products sum in another order);
* bf16: 1e-2, a few bf16 ulps of the output (XLA rounds the SwiGLU
  activation op by op in bf16, torch once from float32; the dense MLP's
  bar, ``tests/test_torch_mlp_kinds.py``);
* the dispatch buffer, the drop mask and the combine of the same expert
  rows are bitwise equal in bf16, at top-k 2 and 4, with and without
  drops: the combine adds each token's contributions in the reference's
  order (ascending expert id, one bf16 rounding per add);
* top-k under ties (a router with a duplicated column): the same expert
  ids as ``jax.lax.top_k`` (the lower id first);
* the aux loss to 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_config
from repro.models import api as japi
from repro.models import moe as JM
from repro_torch.configs.base import QuantConfig, get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import api
from repro_torch.models import moe as TM
from repro_torch.serve.engine import Engine, PagedEngine

TOL = {"float32": 1e-6, "bfloat16": 1e-2}
ARCHS = ("mixtral_8x7b", "dbrx_132b")
# dbrx's top-4 routing over 8 experts (its smoke config routes top-2 over
# 4): four contributions per token in the combine
TOP4 = "dbrx_132b-top4"


def _configs(arch, **change):
    arch, _, variant = arch.partition("-")
    if variant == "top4":
        change = dict(change, n_experts=8, top_k=4)
    return (dataclasses.replace(jax_config(arch).smoke(), **change),
            dataclasses.replace(get_config(arch).smoke(), **change))


def _layer0(jcfg, tcfg, tie=False):
    """Layer 0's MoE weights on both sides (``tie``: the router's column
    1 a copy of column 0, so gates 0 and 1 tie on every token)."""
    jp = japi.init_params(0, jcfg)[0]
    mlp = {k: np.array(v[0]) for k, v in jp["layers"]["mlp"].items()}
    if tie:
        mlp["router"][:, 1] = mlp["router"][:, 0]
    tp = params_from_jax({"layers": {"mlp": mlp}}, tcfg, "cpu")
    return jax.tree.map(jnp.asarray, mlp), tp["layers"]["mlp"]


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _jax_moe(jcfg, capacity):
    return jax.jit(lambda p, x: JM.apply_moe_ffn(p, x, jcfg, "serve",
                                                 capacity=capacity))


def _as_np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.mark.parametrize("capacity", ["drop-free", "formula"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS + (TOP4,))
def test_apply_moe_ffn_matches_jax(arch, dtype, capacity):
    """Drop-free capacity (T, the paged path) and the capacity-factor
    formula (the dense-slot path), with tokens actually dropped: the
    tokens lean towards the router's first expert."""
    jcfg, tcfg = _configs(arch, dtype=dtype)
    jp, tp = _layer0(jcfg, tcfg)
    x = _x((3, 7, tcfg.d_model))
    x += 4.0 * np.asarray(jp["router"], np.float32)[:, 0] / np.linalg.norm(
        np.asarray(jp["router"], np.float32)[:, 0])
    cap = 21 if capacity == "drop-free" else None
    want, jaux = _jax_moe(jcfg, cap)(jp, jnp.asarray(x).astype(jcfg.dtype))
    got, taux = TM.apply_moe_ffn(tp, torch.from_numpy(x).to(
        getattr(torch, dtype)), tcfg, "serve", capacity=cap)
    assert got.dtype == getattr(torch, dtype) and got.shape == x.shape
    want, got = _as_np(want), _as_np(got)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= TOL[dtype] * scale
    assert abs(float(taux) - float(jaux)) <= 1e-6
    # the formula capacity drops tokens here, and drop-free drops none
    x2 = torch.from_numpy(x.reshape(-1, tcfg.d_model)).to(
        getattr(torch, dtype))
    _, top_val, top_idx = TM.route(x2, tp["router"], tcfg.top_k)
    t = x2.shape[0]
    depth = cap or int(np.ceil(t * tcfg.top_k * tcfg.capacity_factor
                               / tcfg.n_experts))
    _, (_, _, keep, _) = TM.dispatch(x2, top_idx, top_val.to(x2.dtype),
                                     tcfg.n_experts, depth)
    assert bool(keep.all()) == (capacity == "drop-free")


@pytest.mark.parametrize("k,e", [(2, 4), (4, 8), (4, 16)])
@pytest.mark.parametrize("cap", [3, 40])
def test_dispatch_and_combine_bitwise(k, e, cap):
    """The same routing through both sides' dispatch and combine, the
    expert rows given (bf16, spread over 2^-8..2^3 so the adds round):
    the buffer, the drop mask and the combined rows are bitwise equal.
    Capacity 3 drops most entries."""
    rng = np.random.default_rng(k * 100 + e + cap)
    t, d = 30, 64
    g = np.exp(rng.standard_normal((t, e)))
    g /= g.sum(-1, keepdims=True)
    idx = np.argsort(-g, 1, kind="stable")[:, :k]
    val = np.take_along_axis(g, idx, 1)
    val = (val / val.sum(-1, keepdims=True)).astype(np.float32)
    x = _x((t, d), seed=1)
    ye = (rng.standard_normal((e * cap, d))
          * np.exp(rng.uniform(-8, 3, (e * cap, 1)))).astype(np.float32)
    jxe, jinfo = JM._dispatch_local(jnp.asarray(x, jnp.bfloat16), None,
                                    jnp.asarray(idx),
                                    jnp.asarray(val, jnp.bfloat16), e, cap)
    want = jax.jit(lambda y, i: JM._combine_local(y, i, t, jnp.bfloat16))(
        jnp.asarray(ye, jnp.bfloat16), jinfo)
    txe, tinfo = TM.dispatch(torch.from_numpy(x).bfloat16(),
                             torch.from_numpy(idx),
                             torch.from_numpy(val).bfloat16(), e, cap)
    got = TM.combine(torch.from_numpy(ye).bfloat16(), tinfo,
                     torch.from_numpy(idx), torch.bfloat16)
    np.testing.assert_array_equal(_as_np(txe), _as_np(jxe))
    np.testing.assert_array_equal(tinfo[2].numpy(), np.asarray(jinfo[3]))
    np.testing.assert_array_equal(_as_np(got), _as_np(want))
    assert bool(tinfo[2].all()) == (cap == 40)


def test_combine_order_is_visible():
    """The bar above has teeth: adding a token's contributions in another
    order (descending expert id) changes some bf16 rows."""
    rng = np.random.default_rng(5)
    t, e, k, cap, d = 30, 8, 4, 40, 64
    idx = np.stack([rng.permutation(e)[:k] for _ in range(t)])
    val = np.full((t, k), 0.25, np.float32)
    ye = (rng.standard_normal((e * cap, d))
          * np.exp(rng.uniform(-8, 3, (e * cap, 1)))).astype(np.float32)
    x = torch.from_numpy(_x((t, d))).bfloat16()
    _, info = TM.dispatch(x, torch.from_numpy(idx),
                          torch.from_numpy(val).bfloat16(), e, cap)
    y = torch.from_numpy(ye).bfloat16()
    fwd = TM.combine(y, info, torch.from_numpy(idx), torch.bfloat16)
    rev = TM.combine(y, info, torch.from_numpy(e - 1 - idx), torch.bfloat16)
    assert not torch.equal(fwd, rev)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_topk_ties_match_jax(dtype):
    """Gates 0 and 1 tie on every token: both sides pick the same ids
    (the lower first), and the FFN outputs agree."""
    jcfg, tcfg = _configs("mixtral_8x7b", dtype=dtype)
    jp, tp = _layer0(jcfg, tcfg, tie=True)
    x = _x((2, 9, tcfg.d_model), seed=3)
    x2 = torch.from_numpy(x.reshape(-1, tcfg.d_model)).to(
        getattr(torch, dtype))
    gates, _, idx = TM.route(x2, tp["router"], tcfg.top_k)
    assert torch.equal(gates[:, 0], gates[:, 1])
    _, jidx = jax.lax.top_k(jnp.asarray(gates.numpy()), tcfg.top_k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert ((idx == 0) | (idx == 1)).any()
    want, _ = _jax_moe(jcfg, None)(jp, jnp.asarray(x).astype(jcfg.dtype))
    got, _ = TM.apply_moe_ffn(tp, torch.from_numpy(x).to(
        getattr(torch, dtype)), tcfg, "serve")
    want, got = _as_np(want), _as_np(got)
    assert np.abs(got - want).max() <= TOL[dtype] * np.abs(want).max()


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_aux_match_jax(arch):
    """The whole float32 model: logits to 1e-5 of their scale, the aux
    loss (mean over layers) to 1e-6; ``api.forward`` drops the aux loss as
    the reference's API does."""
    jcfg, tcfg = _configs(arch)
    jp = japi.init_params(0, jcfg)[0]
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    tokens = np.random.default_rng(1).integers(
        0, tcfg.vocab_size, (2, 11)).astype(np.int32)
    jl, jaux = jax.jit(lambda p, t: JM.forward(p, t, jcfg, "serve"))(
        jp, jnp.asarray(tokens))
    tl, taux = TM.forward(tp, torch.from_numpy(tokens), tcfg, "serve")
    jl = np.asarray(jl)
    assert np.abs(tl.numpy() - jl).max() <= 1e-5 * np.abs(jl).max()
    assert abs(float(taux) - float(jaux)) <= 1e-6
    logits = api.forward(tp, {"tokens": torch.from_numpy(tokens)}, tcfg)
    assert torch.equal(logits, tl)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_jax_round_trip(dtype):
    """The (L, E, d, f) expert leaves and the (L, d, E) router land in the
    model dtype bit-identical to the reference's per-use cast (with
    ``quant.weights`` off the expert leaves, which ``QUANT_WEIGHT_SPEC``
    names, are not float32 masters); norms stay float32."""
    jcfg, tcfg = _configs("dbrx_132b", dtype=dtype)
    jp = japi.init_params(0, jcfg)[0]
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    mlp, jmlp = tp["layers"]["mlp"], jp["layers"]["mlp"]
    n, d, f, e = tcfg.n_layers, tcfg.d_model, tcfg.d_ff, tcfg.n_experts
    shapes = {"router": (n, d, e), "gate": (n, e, d, f),
              "up": (n, e, d, f), "down": (n, e, f, d)}
    assert {k: tuple(v.shape) for k, v in mlp.items()} == shapes
    for k, v in mlp.items():
        assert v.dtype == getattr(torch, dtype)
        want = np.asarray(jnp.asarray(jmlp[k]).astype(dtype).astype(
            jnp.float32))
        np.testing.assert_array_equal(v.float().numpy(), want)
    assert tp["layers"]["ln1"]["g"].dtype == torch.float32


def test_init_params_draws_the_expert_stack_per_layer():
    """``init_params`` for an MoE config: the reference's tree (held in
    ``tests/test_torch_package.py``), every layer and expert its own draw
    at scale 0.02, reproducible from the seed."""
    cfg = get_config("mixtral_8x7b").smoke()
    p = api.init_params(0, cfg, "cpu")
    gate = p["layers"]["mlp"]["gate"]
    assert not torch.equal(gate[0], gate[1])
    assert not torch.equal(gate[0, 0], gate[0, 1])
    assert abs(gate.float().std().item() / 0.02 - 1) < 0.1
    again = api.init_params(0, cfg, "cpu")
    assert torch.equal(again["layers"]["mlp"]["down"],
                       p["layers"]["mlp"]["down"])


@pytest.mark.parametrize("mode", ["w8a16", "w8a8"])
def test_quantized_moe_raises(mode):
    """The reference has no quantized MoE path (its FFN casts the packed
    expert leaves and fails), so neither engine builds one, and the FFN
    refuses packed expert weights."""
    cfg = dataclasses.replace(get_config("mixtral_8x7b").smoke(),
                              quant=QuantConfig(mode))
    params = api.init_params(0, cfg, "cpu")
    for engine in (PagedEngine, Engine):
        with pytest.raises(NotImplementedError, match="no quantized MoE"):
            engine(cfg, params, device="cpu")
    from repro_torch.sharding.rules import quantize_params
    packed = quantize_params(params)["layers"]["mlp"]
    lp = {k: (v if k == "router" else {"q": v["q"][0], "s": v["s"][0]})
          for k, v in packed.items()}
    lp["router"] = lp["router"][0].to(torch.float32)
    with pytest.raises(NotImplementedError, match="moe.py:155"):
        TM.apply_moe_ffn(lp, torch.zeros((1, 2, cfg.d_model)), cfg, "serve")
