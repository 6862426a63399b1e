"""The port's ``Trainer``, checkpoints, elastic helpers and launchers on
the CPU, against the JAX package where it runs here.

The JAX ``Trainer`` itself fails on this tree even on a (1, 1) mesh (the
embedding gather's ``ShardingTypeError``, ROADMAP "Reference
behaviour"), so the numeric reference for whole runs is its plain loop:
``jax.value_and_grad(api.loss_fn)`` + ``adamw_update``, jitted, over the
same ``make_batch`` batches (losses within 1e-4 relative over 10 steps).
The reference's documented behaviour is the reference for checkpointing
(its ``tests/test_checkpoint.py``, counterpart by counterpart, and its
on-disk format, cross-read both ways), failure recovery and resume.
"""
import contextlib
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeConfig as JaxShape
from repro.configs.base import get_config as jax_config
from repro.data.pipeline import make_batch as jax_make_batch
from repro.models import api as japi
from repro.train import checkpoint as jckpt
from repro.train import elastic as JE
from repro.train import optimizer as JO
from repro_torch.configs.base import (ARCH_NAMES, SHAPES, ShapeConfig,
                                      get_config)
from repro_torch.convert import params_from_jax
from repro_torch.launch import train as train_launch
from repro_torch.launch import train_then_serve
from repro_torch.models import api
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import elastic as TE
from repro_torch.train.optimizer import OptConfig, _leaves
from repro_torch.train.trainer import Trainer
from tests._torch_train_cases import one_torch_thread  # noqa: F401

SHAPE = ShapeConfig("smoke", seq_len=32, global_batch=8, kind="train")
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=20)
LOSS_RTOL = 1e-4


def _cfg():
    return get_config("qwen2_0_5b").smoke()


def _jax_params():
    return japi.init_params(0, jax_config("qwen2_0_5b").smoke())[0]


def test_trainer_matches_plain_jax_loop():
    """10 steps from the same weights on the same batches."""
    jcfg = jax_config("qwen2_0_5b").smoke()
    ocfg = JO.OptConfig(**OPT)
    jp = _jax_params()
    tr = Trainer(_cfg(), SHAPE, OptConfig(**OPT), device="cpu")
    tr.params = params_from_jax(jax.tree.map(np.asarray, jp), _cfg(), "cpu",
                                masters=True)
    got = [m["loss"] for m in tr.run(10)["metrics"]]

    @jax.jit
    def step(p, o, b):
        (loss, _), g = jax.value_and_grad(japi.loss_fn, has_aux=True)(
            p, b, jcfg)
        p, o, _ = JO.adamw_update(p, g, o, ocfg)
        return p, o, loss

    opt, want = JO.init_opt_state(jp), []
    shape = JaxShape("smoke", SHAPE.seq_len, SHAPE.global_batch, "train")
    for i in range(10):
        b = {k: jnp.asarray(v)
             for k, v in jax_make_batch(jcfg, shape, i).items()}
        jp, opt, loss = step(jp, opt, b)
        want.append(float(loss))
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=0)
    assert set(tr.metrics_log[0]) == {"step", "loss", "xent", "aux",
                                      "grad_norm", "lr", "step_time"}


def test_train_loss_decreases():
    """The reference's learning check: 25 steps at lr 1e-2 (smoke shape
    64 x 8) take the loss down by more than 0.2."""
    tr = Trainer(_cfg(), ShapeConfig("smoke", seq_len=64, global_batch=8,
                                     kind="train"),
                 OptConfig(lr=1e-2, warmup_steps=5, total_steps=60),
                 device="cpu")
    losses = [m["loss"] for m in tr.run(25)["metrics"]]
    assert losses[-1] < losses[0] - 0.2, (losses[0], losses[-1])


def test_failure_recovery_replays_every_step(tmp_path):
    """An induced failure at step 8 restores the step-5 checkpoint and
    replays steps 5-7 on the same batches, to the same losses bit for
    bit, then completes the run."""
    tr = Trainer(_cfg(), SHAPE, OptConfig(lr=1e-2, warmup_steps=5,
                                          total_steps=60),
                 device="cpu", ckpt_dir=str(tmp_path), ckpt_every=5)
    out = tr.run(12, fail_at=8)
    steps = [m["step"] for m in out["metrics"]]
    assert steps == list(range(8)) + list(range(5, 12))
    first = {m["step"]: m["loss"] for m in out["metrics"][:8]}
    for m in out["metrics"][8:11]:
        assert m["loss"] == first[m["step"]]
    assert ckpt.latest_step(str(tmp_path)) == 12


def test_resume_bitwise_equals_uninterrupted(tmp_path):
    """The reference's resume test: checkpoint at 5, train to 10;
    restore the step-5 checkpoint into a fresh trainer and train to 10:
    identical masters and moments."""
    d = str(tmp_path)
    opt = OptConfig(lr=1e-2, warmup_steps=2, total_steps=20)
    a = Trainer(_cfg(), SHAPE, opt, device="cpu", ckpt_dir=d, ckpt_every=5)
    a.run(10)
    b = Trainer(_cfg(), SHAPE, opt, device="cpu", ckpt_dir=d)
    assert b.restore() == 10 and b.step == 10
    b2 = Trainer(_cfg(), SHAPE, opt, device="cpu", ckpt_dir=d)
    step, tree = ckpt.restore(d, b2.state_tree(), step=5)
    b2.params, b2.opt_state, b2.step = tree["params"], tree["opt"], step
    b2.saver = None
    b2.run(10)
    for x, y in zip(_leaves(a.state_tree()), _leaves(b2.state_tree())):
        assert torch.equal(x, y)


# -- checkpoint counterparts of tests/test_checkpoint.py -----------------------

def _tree(seed=0):
    r = np.random.default_rng(seed)
    return {"a": torch.tensor(r.normal(size=(4, 8)).astype(np.float32)),
            "nested": {"b": torch.arange(7), "c": torch.tensor(1.5)}}


def _zeros_like(t):
    return {"a": torch.zeros(4, 8), "nested": {"b": torch.zeros(7),
                                               "c": torch.zeros(())}}


def test_save_restore_exact(tmp_path):
    t = _tree()
    ckpt.save(str(tmp_path), 5, t)
    step, out = ckpt.restore(str(tmp_path), _zeros_like(t))
    assert step == 5
    for a, b in zip(_leaves(t), _leaves(out)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_latest_pointer_and_retention(tmp_path):
    t = _tree()
    for s in (1, 2, 3, 4, 5):
        ckpt.save(str(tmp_path), s, t, keep=2)
    assert ckpt.latest_step(str(tmp_path)) == 5
    kept = sorted(d for d in os.listdir(tmp_path) if d.startswith("step-"))
    assert kept == ["step-4", "step-5"]


def test_crash_mid_save_keeps_last_good(tmp_path):
    """A tmp- dir left behind by a crash must not corrupt LATEST."""
    t = _tree()
    ckpt.save(str(tmp_path), 1, t)
    os.makedirs(tmp_path / "tmp-2")
    with open(tmp_path / "tmp-2" / "arrays.npz", "wb") as f:
        f.write(b"partial garbage")
    step, out = ckpt.restore(str(tmp_path), _zeros_like(t))
    assert step == 1 and torch.equal(out["a"], t["a"])


def test_restore_shape_mismatch_raises(tmp_path):
    ckpt.save(str(tmp_path), 1, _tree())
    bad = {"a": torch.zeros(3, 3), "nested": {"b": torch.zeros(7),
                                              "c": torch.zeros(())}}
    with pytest.raises(ValueError):
        ckpt.restore(str(tmp_path), bad)


def test_async_saver_overlap(tmp_path):
    saver = ckpt.AsyncSaver(str(tmp_path))
    saver.save(3, _tree())
    saver.save(4, _tree(1))   # waits for the first, then snapshots
    saver.wait()
    assert ckpt.latest_step(str(tmp_path)) == 4
    assert set(saver.times) == {3, 4}


# -- the two packages read each other's checkpoints ----------------------------

def _state_trees():
    """A trainer's {"params", "opt"} tree in both packages' forms."""
    jp = _jax_params()
    jtree = {"params": jp, "opt": JO.init_opt_state(jp)}
    jtree["opt"]["mu"] = jax.tree.map(lambda a: a + 1, jtree["opt"]["mu"])
    jtree["opt"]["step"] = jnp.asarray(7, jnp.int32)
    ttree = jax.tree.map(lambda a: torch.tensor(np.asarray(a)), jtree)
    return jtree, ttree


def test_checkpoint_from_the_jax_package_restores_in_the_port(tmp_path):
    jtree, ttree = _state_trees()
    jckpt.save(str(tmp_path), 7, jtree)
    template = jax.tree.map(torch.zeros_like, ttree)
    step, out = ckpt.restore(str(tmp_path), template)
    assert step == 7
    for a, b in zip(_leaves(ttree), _leaves(out)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_from_the_port_restores_in_the_jax_package(tmp_path):
    jtree, ttree = _state_trees()
    ckpt.save(str(tmp_path), 7, ttree)
    step, out = jckpt.restore(str(tmp_path),
                              jax.tree.map(np.zeros_like, jtree))
    assert step == 7
    for a, b in zip(jax.tree.leaves(jtree), jax.tree.leaves(out)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert np.asarray(a).dtype == np.asarray(b).dtype


# -- elastic -------------------------------------------------------------------

def test_drop_slowest_microbatch_matches_reference():
    """The reference's unit case, and a random stack against the JAX
    function (float32, 1e-6)."""
    g = {"w": torch.stack([torch.ones(2, 2) * i for i in range(4)])}
    out = TE.drop_slowest_microbatch(g, torch.tensor([True, True, False,
                                                      True]))
    assert torch.allclose(out["w"], torch.ones(2, 2) * (0 + 1 + 3) / 3)
    rng = np.random.default_rng(4)
    stack = {"a": rng.standard_normal((5, 3, 4)).astype(np.float32),
             "n": {"b": rng.standard_normal((5, 6)).astype(np.float32)}}
    for ok in ([True] * 5, [False, True, True, False, True], [False] * 5):
        want = JE.drop_slowest_microbatch(jax.tree.map(jnp.asarray, stack),
                                          jnp.asarray(ok))
        got = TE.drop_slowest_microbatch(
            jax.tree.map(torch.tensor, stack), torch.tensor(ok))
        for a, b in zip(_leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-6)


def test_reshard_checkpoint_onto_a_device_and_mesh_raises(tmp_path):
    t = _tree()
    ckpt.save(str(tmp_path), 2, t)
    step, out = TE.reshard_checkpoint(str(tmp_path), _zeros_like(t), "cpu")
    assert step == 2 and torch.equal(out["a"], t["a"])
    with pytest.raises(NotImplementedError, match="item 9"):
        TE.reshard_checkpoint(str(tmp_path), _zeros_like(t), object())


def test_watchdog_flags_stragglers():
    tr = Trainer(_cfg(), SHAPE, OptConfig(), device="cpu")
    for i, dt in enumerate((1.0, 1.0, 1.1, 0.9, 1.0, 3.0, 1.0)):
        tr.step = i
        tr._watchdog(dt)
    assert [s["step"] for s in tr.stragglers] == [5]


# -- inputs and launchers ------------------------------------------------------

@pytest.mark.parametrize("name", ARCH_NAMES)
def test_train_inputs_match_reference(name):
    t = SHAPES["train_4k"]
    jb, jaxes = japi.train_inputs(jax_config(name), JaxShape(
        t.name, t.seq_len, t.global_batch, t.kind))
    tb, taxes = api.train_inputs(get_config(name), t)
    assert taxes == jaxes and sorted(tb) == sorted(jb)
    for k in jb:
        assert tuple(tb[k].shape) == jb[k].shape
        assert str(tb[k].dtype).replace("torch.", "") == str(jb[k].dtype)
        assert tb[k].device.type == "meta"


def test_train_launcher_prints_the_reference_keys():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = train_launch.main(["--arch", "qwen2_0_5b", "--smoke",
                                 "--device", "cpu", "--steps", "3"])
    printed = json.loads(buf.getvalue())
    assert printed == res
    assert set(printed) == {"arch", "steps", "first_loss", "final_loss",
                            "stragglers"}
    assert printed["arch"] == "qwen2_0_5b-smoke" and printed["steps"] == 3
    with pytest.raises(NotImplementedError, match="item 9"):
        train_launch.main(["--arch", "qwen2_0_5b", "--smoke", "--device",
                           "cpu", "--mesh", "4,2"])


def test_train_then_serve_runs_on_the_cpu():
    """The example's lines at a cut step count (the schedule stays the
    example's 150-step one)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = train_then_serve.main(["--device", "cpu", "--steps", "4"])
    text = buf.getvalue()
    assert "step    0 loss" in text and "copy-task accuracy  exact:" in text
    assert "accuracy drop with SOLE, zero retraining:" in text
    assert 0 <= res["exact"] <= 1 and 0 <= res["sole"] <= 1
    assert len(res["losses"]) == 4
