"""Shared set-up of the train-step parity files
(``test_torch_train_step.py``, ``test_torch_train_step_families.py``):
one config's JAX loss, gradients and one AdamW update, computed once per
config (jitted), beside the same step through the port on the CPU, from
the JAX ``init_params`` weights converted to float32 masters and one
seeded ``make_batch``.

Bars (float32 smoke configs): loss within 1e-5 relative; every gradient
leaf within 1e-4 of its leaf's largest magnitude; the gradient norm
within 1e-5 relative; the params after one ``adamw_update`` (default
``OptConfig``: lr 3e-6 at step 1) within 1e-6 absolute. The two
frameworks sum in other orders and XLA contracts some multiply-adds, so
nothing here is bitwise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeConfig as JaxShape
from repro.configs.base import get_config as jax_config
from repro.data.pipeline import make_batch as jax_make_batch
from repro.models import api as japi
from repro.train import optimizer as JO
from repro_torch.configs.base import get_config
from repro_torch.convert import params_from_jax, serving_view
from repro_torch.models import api
from repro_torch.train import optimizer as TO
from repro_torch.train.optimizer import _leaves
from repro_torch.train.trainer import batch_to_device, loss_and_grads

SHAPE = (32, 4)            # seq_len, global_batch of the step's batch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch's CPU ops at these smoke sizes on one thread, for the module
    (restored after): beside the suite's other parallel workers a pool of
    one thread per core oversubscribes the machine, and a train loop of
    small ops then spends its time waiting (25 smoke steps took 62 s on
    the default pool and 9.6 s on one thread beside five busy
    processes). Each file compares runs of one setting."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
GNORM_RTOL = 1e-5
PARAM_ATOL = 1e-6


def configs(name, **change):
    return (dataclasses.replace(jax_config(name).smoke(), **change),
            dataclasses.replace(get_config(name).smoke(), **change))


def batch(jcfg, step=0):
    return jax_make_batch(jcfg, JaxShape("step", *SHAPE, "train"), step)


@jax.jit
def _jax_update(p, g, s):
    return JO.adamw_update(p, g, s, JO.OptConfig())


def jax_inputs(name, **change):
    """The JAX ``init_params`` weights (seed 0) and the step's batch."""
    jcfg, _ = configs(name, **change)
    return dict(params=japi.init_params(0, jcfg)[0], batch=batch(jcfg))


def jax_step(name, **change):
    """(JAX params, batch, loss, metrics, grads, params after one update)
    for the config's smoke family with ``change`` applied."""
    jcfg, _ = configs(name, **change)
    inp = jax_inputs(name, **change)
    jp, b = inp["params"], inp["batch"]
    f = jax.jit(jax.value_and_grad(japi.loss_fn, has_aux=True),
                static_argnums=2)
    (loss, metrics), grads = f(jp, {k: jnp.asarray(v) for k, v in b.items()},
                               jcfg)
    new_p, _, opt_m = _jax_update(jp, grads, JO.init_opt_state(jp))
    return dict(params=jp, batch=b, loss=float(loss),
                metrics={k: float(v) for k, v in metrics.items()},
                grads=jax.tree.leaves(grads), grad_norm=float(
                    opt_m["grad_norm"]), updated=jax.tree.leaves(new_p))


def port_step(ref, name, **change):
    """The same step through the port: (loss, metrics, grad leaves,
    grad norm, params after one update)."""
    _, tcfg = configs(name, **change)
    masters = params_from_jax(jax.tree.map(np.asarray, ref["params"]), tcfg,
                              "cpu", masters=True)
    loss, metrics, grads = loss_and_grads(
        masters, batch_to_device(ref["batch"], "cpu"), tcfg)
    new_p, _, opt_m = TO.adamw_update(masters, grads,
                                      TO.init_opt_state(masters),
                                      TO.OptConfig())
    return dict(loss=loss.item(),
                metrics={k: v.item() for k, v in metrics.items()},
                grads=_leaves(grads), grad_norm=opt_m["grad_norm"].item(),
                updated=_leaves(new_p))


def leaf_errors(got, want):
    """Each leaf's max |got - want| over its max |want| (0 for empty)."""
    out = []
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32)
        g = g.detach().float().numpy()
        assert g.shape == w.shape
        if w.size == 0:
            out.append(0.0)
            continue
        out.append(float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)))
    return out


def check_step(ref, got, loss_rtol=LOSS_RTOL, grad_rtol=GRAD_RTOL,
               gnorm_rtol=GNORM_RTOL, param_atol=PARAM_ATOL):
    assert abs(got["loss"] - ref["loss"]) <= loss_rtol * abs(ref["loss"])
    for k in ("xent", "aux"):
        assert abs(got["metrics"][k] - ref["metrics"][k]) <= \
            loss_rtol * max(abs(ref["metrics"][k]), 1.0)
    assert len(got["grads"]) == len(ref["grads"])
    errs = leaf_errors(got["grads"], ref["grads"])
    assert max(errs) <= grad_rtol, errs
    assert abs(got["grad_norm"] - ref["grad_norm"]) <= \
        gnorm_rtol * ref["grad_norm"]
    for g, w in zip(got["updated"], ref["updated"]):
        w = np.asarray(w, np.float32)
        if w.size:
            assert np.abs(g.numpy() - w).max() <= param_atol


def remat_grads(name):
    """The port's gradients of the step under remat none, dots and full
    (bitwise equal on the CPU: the recompute runs the same ops)."""
    ref = jax_inputs(name)
    out = {}
    for remat in ("none", "dots", "full"):
        _, tcfg = configs(name, remat=remat)
        masters = params_from_jax(jax.tree.map(np.asarray, ref["params"]),
                                  tcfg, "cpu", masters=True)
        _, _, grads = loss_and_grads(
            masters, batch_to_device(ref["batch"], "cpu"), tcfg)
        out[remat] = _leaves(grads)
    return out


def assert_bitwise(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def check_masters_view(name, ref):
    """``serving_view`` of float32 masters (``init_params(masters=True)``,
    ``params_from_jax(masters=True)`` of the JAX weights) is bitwise the
    tree the serve path stores in bf16: the same leaves, dtypes and bits."""
    _, cfg = configs(name, dtype="bfloat16")
    jp = jax.tree.map(np.asarray, ref["params"])
    for want, masters in (
            (api.init_params(0, cfg, "cpu"),
             api.init_params(0, cfg, "cpu", masters=True)),
            (params_from_jax(jp, cfg, "cpu"),
             params_from_jax(jp, cfg, "cpu", masters=True))):
        assert all(t.dtype == torch.float32 for t in _leaves(masters))
        got = serving_view(masters, cfg)
        for a, b in zip(_leaves(want), _leaves(got)):
            assert a.dtype == b.dtype and torch.equal(a, b)
