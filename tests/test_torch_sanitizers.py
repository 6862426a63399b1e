"""``repro_torch.analysis.sanitizers``: the reference's sanitizer tests
(``tests/test_analysis.py:315-458``) on the port's counters. The
sentinel watches zero-argument counters (kernel libraries loaded, device
segments) where the reference watches jit caches; budget and freeze
behave alike. On a CPU ``PagedEngine`` the guarded trace runs clean and
the refcount sweep catches seeded drift on the very next step. The sync
guard exists on the card only: its tests carry the ``cuda`` marker and
skip here (this file imports no JAX, so they run on the card with
``python -m pytest -q --noconftest -m cuda tests/test_torch_sanitizers.py``).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.analysis.sanitizers import (RecompileError,
                                             RecompileSentinel, attach,
                                             default_budgets,
                                             sanitize_enabled)
from repro_torch.configs.base import get_config
from repro_torch.kernels import build
from repro_torch.models import api
from repro_torch.serve.engine import PagedEngine, Request


class _Counter:
    def __init__(self):
        self.n = 0

    def __call__(self):
        return self.n


def test_sentinel_budget_violation():
    c = _Counter()
    s = RecompileSentinel({"f": c}, {"f": 1})
    c.n = 1
    s.check()
    c.n = 2                              # second variant: over budget
    with pytest.raises(RecompileError, match="budget"):
        s.check()


def test_sentinel_freeze_catches_any_growth():
    c = _Counter()
    s = RecompileSentinel({"f": c}, {"f": 100})
    c.n = 1
    assert s.freeze() == {"f": 1}
    s.check()                            # no growth: fine
    c.n = 2
    with pytest.raises(RecompileError, match="grew after freeze"):
        s.check()


def test_sentinel_rejects_non_counters():
    with pytest.raises(TypeError, match="zero-argument"):
        RecompileSentinel({"f": lambda x: x}, {})
    with pytest.raises(TypeError, match="zero-argument"):
        RecompileSentinel({"f": lambda: "1"}, {})


def test_sanitize_enabled_env(monkeypatch):
    monkeypatch.delenv("REPRO_SANITIZE", raising=False)
    assert not sanitize_enabled()
    monkeypatch.setenv("REPRO_SANITIZE", "0")
    assert not sanitize_enabled()
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    assert sanitize_enabled()


@pytest.fixture(scope="module")
def exact_lm():
    cfg = get_config("qwen2_0_5b").smoke()
    params = api.init_params(0, cfg, "cpu")
    cfg = dataclasses.replace(cfg, softmax_mode="exact", norm_mode="exact",
                              logit_int8=False)
    return cfg, params


def _engine(cfg, params, device="cpu", **kw):
    base = dict(num_blocks=40, block_size=8, max_seq_len=64, max_running=4,
                decode_batch=4, prefill_chunk=8, device=device)
    base.update(kw)
    return PagedEngine(cfg, params, **base)


def _reqs(cfg, n, seed=0, new=8):
    rng = np.random.default_rng(seed)
    return [Request(prompt=rng.integers(0, cfg.vocab_size, size=16)
                    .astype(np.int32), max_new_tokens=new)
            for _ in range(n)]


def test_engine_guarded_decode_is_clean(exact_lm):
    """Warm-up -> freeze -> replay: no counter grows, the sweep runs, the
    report has the reference's keys; detach restores the methods."""
    cfg, params = exact_lm
    eng = _engine(cfg, params)
    san = attach(eng, sweep_every=2)
    eng.generate(_reqs(cfg, 3, seed=0))          # warm-up
    assert san.steps > 0
    frozen = san.freeze()
    assert set(frozen) == {"kernel_libs"}        # no device segments on CPU
    out = eng.generate(_reqs(cfg, 3, seed=1))
    assert [len(o) for o in out] == [8, 8, 8]
    rep = san.report()
    assert rep["transfers_in_decode"] == 0
    assert rep["refcount_sweeps"] > 0
    assert rep["decode_compile_count"] == len(build._LIBS)
    assert rep["decode_compile_count"] <= default_budgets(eng)["kernel_libs"]
    assert {"total_compile_count", "sanitized_steps", "segments",
            "sanctioned_syncs"} <= set(rep)
    san.detach()
    assert eng.step.__func__ is PagedEngine.step
    assert "_tensor" not in eng.__dict__ and "_host" not in eng.__dict__


def test_engine_deliberate_growth_caught(exact_lm, monkeypatch):
    """A kernel library loaded after freeze (a build inside the warmed
    loop) fails the next step."""
    cfg, params = exact_lm
    eng = _engine(cfg, params)
    attach(eng).freeze()
    monkeypatch.setitem(build._LIBS, "late_build", None)
    with pytest.raises(RecompileError, match="grew after freeze"):
        eng.generate(_reqs(cfg, 1, seed=2))


def test_engine_refcount_sweep_catches_corruption(exact_lm):
    """The periodic sweep runs check_refcounts through step(): seeded
    refcount drift fails the very next step."""
    cfg, params = exact_lm
    eng = _engine(cfg, params)
    san = attach(eng, sweep_every=1)
    eng.generate(_reqs(cfg, 1, seed=0))
    assert san.sweeps == san.steps
    eng.cache._ref[1] += 1               # deliberate accounting drift
    with pytest.raises(AssertionError):
        eng.step()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_guarded_trace_on_card_is_clean(cuda_device, exact_lm):
    """On the card the guarded replay runs under the sync guard: only the
    engine's sanctioned transfers sync, no segment is allocated."""
    cfg, _ = exact_lm
    eng = _engine(cfg, api.init_params(0, cfg, cuda_device),
                  device=cuda_device)
    san = attach(eng, sweep_every=2)
    eng.generate(_reqs(cfg, 3, seed=0))
    frozen = san.freeze()
    assert set(frozen) == {"kernel_libs", "segments"}
    out = eng.generate(_reqs(cfg, 3, seed=0))
    assert [len(o) for o in out] == [8, 8, 8]
    rep = san.report()
    assert rep["sanctioned_syncs"] > 0 and rep["refcount_sweeps"] > 0
    assert san.sentinel.sizes() == frozen
    san.detach()


@pytest.mark.cuda
def test_injected_item_raises_on_card(cuda_device, exact_lm):
    """An implicit sync inside a guarded step raises out of step()."""
    cfg, _ = exact_lm
    eng = _engine(cfg, api.init_params(0, cfg, cuda_device),
                  device=cuda_device)
    san = attach(eng)
    eng.generate(_reqs(cfg, 1, seed=0))
    san.freeze()
    san._inner_step = lambda: torch.ones(1, device=cuda_device).sum().item()
    try:
        with pytest.raises(RuntimeError):
            eng.step()
    finally:
        torch.cuda.set_sync_debug_mode(0)
