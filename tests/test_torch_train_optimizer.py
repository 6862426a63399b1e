"""The port's AdamW (``repro_torch.train.optimizer``) against the JAX
package's ``repro.train.optimizer`` on the CPU, on one numpy-seeded tree:
``OptConfig`` field for field, ``schedule`` at steps 0-300, ``global_norm``
and ``adamw_update`` (with clipping on and off, several steps) within
1e-6 relative (float32 elementwise ops in the reference's order; XLA may
contract a multiply-add the eager ops round twice). The update is in
place, so each test hands it trees of its own.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import optimizer as JO
from repro_torch.train import optimizer as TO
from tests._torch_train_cases import one_torch_thread  # noqa: F401

RTOL = 1e-6


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"embed": {"table": rng.standard_normal((16, 8)) * scale},
            "layers": {"w": rng.standard_normal((2, 8, 4)) * scale,
                       "g": 1 + rng.standard_normal((2, 8)) * scale},
            "final": rng.standard_normal((8,)) * scale}


def _f32(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _to_torch(tree):
    return jax.tree.map(lambda a: torch.tensor(np.asarray(a)), tree)


def _close(t, j):
    for a, b in zip(jax.tree.leaves(jax.tree.map(lambda x: x.numpy(), t)),
                    jax.tree.leaves(j)):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=RTOL,
                                   atol=RTOL * np.abs(b).max())


def test_opt_config_matches_reference():
    assert [(f.name, f.default) for f in dataclasses.fields(TO.OptConfig)] \
        == [(f.name, f.default) for f in dataclasses.fields(JO.OptConfig)]


@pytest.mark.parametrize("warmup,total", ((100, 10000), (10, 150), (0, 1),
                                          (30, 200)))
def test_schedule_matches_reference(warmup, total):
    cfg = dict(lr=3e-4, warmup_steps=warmup, total_steps=total)
    t, j = TO.OptConfig(**cfg), JO.OptConfig(**cfg)
    steps = np.arange(0, 301)
    got = np.array([TO.schedule(torch.tensor(s, dtype=torch.int32), t).item()
                    for s in steps])
    want = np.asarray(jax.vmap(lambda s: JO.schedule(s, j))(
        jnp.asarray(steps, jnp.int32)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


def test_global_norm_and_init_state():
    tree = _f32(_tree(1))
    got = TO.global_norm(_to_torch(tree)).item()
    want = float(JO.global_norm(tree))
    assert abs(got - want) <= RTOL * want
    st = TO.init_opt_state(_to_torch(tree))
    assert st["step"].dtype == torch.int32 and int(st["step"]) == 0
    assert jax.tree.structure(jax.tree.map(lambda x: 0, st["mu"])) == \
        jax.tree.structure(jax.tree.map(lambda x: 0, tree))


@pytest.mark.parametrize("clip", (True, False))
def test_adamw_update_matches_reference(clip):
    """Five updates on the same params/grads: with clip_norm 1.0 the
    grads (norm ~9) are clipped, with 100.0 they are not. Decay applies to
    the 2-D and 3-D leaves only."""
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=10,
               clip_norm=1.0 if clip else 100.0)
    tcfg, jcfg = TO.OptConfig(**cfg), JO.OptConfig(**cfg)
    jp = _f32(_tree(2))
    tp = _to_torch(jp)
    js, ts = JO.init_opt_state(jp), TO.init_opt_state(tp)
    for i in range(5):
        g = _f32(_tree(10 + i, scale=0.5))
        jp, js, jm = JO.adamw_update(jp, g, js, jcfg)
        tp, ts, tm = TO.adamw_update(tp, _to_torch(g), ts, tcfg)
        _close(tp, jp)
        _close(ts["mu"], js["mu"])
        _close(ts["nu"], js["nu"])
        assert int(ts["step"]) == int(js["step"]) == i + 1
        for k in ("grad_norm", "lr"):
            assert abs(tm[k].item() - float(jm[k])) <= RTOL * float(jm[k])
    gnorm = float(jm["grad_norm"])
    assert (gnorm > 1.0) == clip or not clip


def test_update_writes_in_place():
    """The trees returned are the ones given, their leaves the same
    tensors, holding the reference's new params and moments; only the
    step is a new tensor."""
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=10)
    jp = _f32(_tree(3))
    p = _to_torch(jp)
    st = TO.init_opt_state(p)
    before = jax.tree.leaves((p, st["mu"], st["nu"]))
    g = _f32(_tree(20))
    q, sq, _ = TO.adamw_update(p, _to_torch(g), st, TO.OptConfig(**cfg))
    assert all(a is b for a, b in zip(
        before, jax.tree.leaves((q, sq["mu"], sq["nu"]))))
    assert int(sq["step"]) == 1 and int(st["step"]) == 0
    jq, js, _ = JO.adamw_update(jp, g, JO.init_opt_state(jp),
                                JO.OptConfig(**cfg))
    _close(p, jq)
    _close(st["mu"], js["mu"])
    _close(st["nu"], js["nu"])
