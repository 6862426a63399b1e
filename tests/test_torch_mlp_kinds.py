"""The port's ``apply_mlp`` for every MLP kind of the dense family
(``swiglu``, ``geglu``, ``gelu``, ``relu2``) against the JAX package's,
on the same numpy-seeded activations and weights (the JAX ``init_mlp``
tree converted through numpy), and the init trees of the two-matrix
kinds.

Tolerances, relative to the largest output:

* float32 weights and activations: 1e-6 (the products sum in another
  order; ``F.gelu``'s tanh form rounds apart from ``jax.nn.gelu``'s op
  chain by an ulp);
* bf16: 1e-2, a few bf16 ulps of the output (XLA rounds the activation
  op by op in bf16, torch once from float32);
* w8a8 (int8 weights packed by each side from the same float32 masters,
  activations quantized per row on the fly, or handed over as an
  ``(int8 codes, scale)`` pair as a quant-out norm does): 1e-6 (the int8
  products are exact int32 sums); the packed codes are equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import QuantConfig as JaxQuantConfig
from repro.configs.base import get_config as jax_config
from repro.core.sole.quant import quantize_act as jax_quantize_act
from repro.models import layers as JL
from repro.sharding.rules import quantize_params as jax_quantize_params
from repro_torch.configs.base import QuantConfig, get_config
from repro_torch.core.sole.quant import quantize_act
from repro_torch.models import api
from repro_torch.models import layers as TL
from repro_torch.sharding.rules import quantize_params

KINDS = ("swiglu", "geglu", "gelu", "relu2")
TOL = {"float32": 1e-6, "bfloat16": 1e-2, "w8a8": 1e-6}


def _configs(kind, dtype="float32", quant="off"):
    kw = dict(mlp_kind=kind, dtype=dtype)
    return (dataclasses.replace(jax_config("qwen2_0_5b").smoke(),
                                quant=JaxQuantConfig(quant), **kw),
            dataclasses.replace(get_config("qwen2_0_5b").smoke(),
                                quant=QuantConfig(quant), **kw))


def _weights(kind, jcfg):
    p, _ = JL.split_params(JL.init_mlp(jax.random.PRNGKey(len(kind)), jcfg))
    return jax.tree.map(lambda a: np.array(a), p)


def _x(kind, d, dtype):
    x = np.random.default_rng(len(kind)).standard_normal((2, 5, d)) * 3
    return x.astype(np.float32), jnp.asarray(x, dtype), torch.from_numpy(
        x.astype(np.float32)).to(TL.torch_dtype(dtype))


def _close(got, want, tol):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= tol * scale, (
        np.abs(got - want).max(), scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", KINDS)
def test_apply_mlp_matches_reference(kind, dtype):
    jcfg, tcfg = _configs(kind, dtype)
    w = _weights(kind, jcfg)
    assert set(w) == ({"gate", "up", "down"} if kind in ("swiglu", "geglu")
                      else {"up", "down"})
    _, jx, tx = _x(kind, tcfg.d_model, dtype)
    want = jax.jit(lambda x, p: JL.apply_mlp(x, p, jcfg))(jx, w)
    tw = {k: torch.from_numpy(v).to(TL.torch_dtype(dtype))
          for k, v in w.items()}
    got = TL.apply_mlp(tx, tw, tcfg)
    assert got.dtype == TL.torch_dtype(dtype)
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("pair", [False, True], ids=["on-the-fly", "pair"])
@pytest.mark.parametrize("kind", KINDS)
def test_apply_mlp_w8a8_matches_reference(kind, pair):
    jcfg, tcfg = _configs(kind, quant="w8a8")
    w = _weights(kind, jcfg)
    jq = jax_quantize_params({k: jnp.asarray(v) for k, v in w.items()})
    tq = quantize_params({k: torch.from_numpy(v) for k, v in w.items()})
    for k in w:
        np.testing.assert_array_equal(tq[k]["q"].numpy(),
                                      np.asarray(jq[k]["q"]))
    x, jx, tx = _x(kind, tcfg.d_model, "float32")
    if pair:
        jx, tx = jax_quantize_act(jx), quantize_act(tx)
    want = jax.jit(lambda x, p: JL.apply_mlp(x, p, jcfg))(jx, jq)
    _close(TL.apply_mlp(tx, tq, tcfg), want, TOL["w8a8"])


@pytest.mark.parametrize("kind", KINDS)
def test_init_mlp_tree_matches_reference(kind):
    """The stacked MLP leaves of ``init_params``: gate/up/down for the
    gated kinds, up/down otherwise, at the reference's shapes; float32
    masters under quantized weights."""
    jcfg, tcfg = _configs(kind)
    want = {k: (tcfg.n_layers,) + v.shape
            for k, v in _weights(kind, jcfg).items()}
    params = api.init_params(0, tcfg, "cpu")["layers"]["mlp"]
    assert {k: tuple(v.shape) for k, v in params.items()} == want
    q = api.init_params(0, dataclasses.replace(
        tcfg, dtype="bfloat16", quant=QuantConfig("w8a8")), "cpu")
    assert all(v.dtype == torch.float32
               for v in q["layers"]["mlp"].values())


def test_unknown_mlp_kind_raises():
    _, tcfg = _configs("swiglu")
    cfg = dataclasses.replace(tcfg, mlp_kind="rwkv_cmix")
    with pytest.raises(ValueError, match="mlp_kind"):
        api.init_params(0, cfg, "cpu")
    with pytest.raises(ValueError, match="mlp_kind"):
        TL.apply_mlp(torch.zeros((1, 1, cfg.d_model)), {"up": None}, cfg)
