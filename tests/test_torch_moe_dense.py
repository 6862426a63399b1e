"""The MoE family through the port's dense-slot ``Engine`` on the CPU
against the JAX ``Engine`` (its config with ``ops_backend="pallas"``:
Pallas kernels in interpret mode), on the same smoke weights.

The dense-slot path routes with the capacity-factor formula, so tokens
drop (the batch is left-padded with token 0, whose identical rows crowd
two experts), and the trace asserts that some do. The trace: six greedy
prompts of mixed lengths served four at a time, request 1 with an eos id
from the JAX engine's own output; tokens and finish reasons are equal in
exact and in SOLE mode.

Mixtral's sliding window: at window 8 the dense cache is a rolling ring
of 8 columns that decode overwrites, and tokens still equal the JAX
engine's; the paged engine refuses a ``max_seq_len`` past the window
(its pages are append-only).

The launcher serves ``--arch mixtral_8x7b|dbrx_132b --smoke`` on the CPU
through both engines (and the paged one with the n-gram drafter under
open-loop arrivals), each request getting ``--new-tokens`` tokens, and
refuses ``--quantize`` for MoE.
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro.configs.base import get_config as jax_config
from repro.models import api as japi
from repro.serve.engine import Engine as JaxEngine
from repro.serve.engine import Request as JaxRequest
from repro_torch.configs.base import get_config
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as launcher
from repro_torch.models import moe as TM
from repro_torch.serve.engine import Engine, PagedEngine, Request

ARCHS = ("mixtral_8x7b", "dbrx_132b")
PROMPT_LENS = (5, 20, 11, 3, 16, 9)
EXACT = dict(softmax_mode="exact", norm_mode="exact", logit_int8=False)


def _engines(arch, mode, max_len=32, **change):
    kw = dict(EXACT if mode == "exact" else {}, **change)
    jcfg = dataclasses.replace(jax_config(arch).smoke(), ops_backend="pallas",
                               **kw)
    tcfg = dataclasses.replace(get_config(arch).smoke(), **kw)
    params = japi.init_params(0, jcfg)[0]
    tparams = params_from_jax(jax.tree.map(np.asarray, params), tcfg, "cpu")
    return (tcfg, JaxEngine(jcfg, params, batch_size=4, max_len=max_len),
            Engine(tcfg, tparams, batch_size=4, max_len=max_len,
                   device="cpu"))


def _requests(cls, prompts, new, eos=None):
    return [cls(prompt=p, max_new_tokens=new,
                eos_ids=(eos,) if eos is not None and i == 1 else ())
            for i, p in enumerate(prompts)]


@pytest.mark.parametrize("mode", ["exact", "sole"])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_jax_engine(arch, mode, monkeypatch):
    tcfg, jeng, teng = _engines(arch, mode)
    rng = np.random.default_rng(len(arch))
    prompts = [rng.integers(0, tcfg.vocab_size, n).astype(np.int32)
               for n in PROMPT_LENS]
    eos = int(jeng.generate(_requests(JaxRequest, prompts, 8))[1][2])
    jout = jeng.generate(_requests(JaxRequest, prompts, 8, eos))
    kept = []
    orig = TM.dispatch

    def spy(*a):
        xe, info = orig(*a)
        kept.append(bool(info[2].all()))
        return xe, info

    monkeypatch.setattr(TM, "dispatch", spy)
    tout = teng.generate(_requests(Request, prompts, 8, eos))
    assert tout == jout
    assert teng.finish_reasons == jeng.finish_reasons
    assert teng.finish_reasons[1] == "eos" and tout[1][-1] == eos
    assert not all(kept)                  # the formula capacity dropped


def test_sliding_window_ring_matches_jax():
    """Window 8, prompts up to 11 tokens and 8 new ones: prefill keeps the
    last 8 columns, decode writes the ring at ``pos % 8``."""
    tcfg, jeng, teng = _engines("mixtral_8x7b", "exact", max_len=24,
                                window=8)
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, tcfg.vocab_size, n).astype(np.int32)
               for n in (5, 11, 3, 9)]
    jout = jeng.generate(_requests(JaxRequest, prompts, 8))
    tout = teng.generate(_requests(Request, prompts, 8))
    assert tout == jout and all(len(o) == 8 for o in tout)
    with pytest.raises(ValueError, match="sliding window"):
        PagedEngine(tcfg, teng.params, device="cpu", max_seq_len=16)
    PagedEngine(tcfg, teng.params, device="cpu", max_seq_len=8)


@pytest.mark.parametrize("extra", [["--engine", "dense"],
                                   ["--engine", "paged"],
                                   ["--engine", "paged", "--spec-decode",
                                    "ngram", "--open-loop", "0.5"]],
                         ids=["dense", "paged", "paged-ngram-open-loop"])
@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_serves_moe_on_the_cpu(arch, extra, capsys):
    outs = launcher.main(["--arch", arch, "--smoke", "--device", "cpu",
                          "--requests", "5", "--prompt-len", "12",
                          "--new-tokens", "6", *extra])
    assert [len(o) for o in outs] == [6] * 5
    assert "device=cpu" in capsys.readouterr().out


def test_launcher_refuses_quantized_moe():
    with pytest.raises(NotImplementedError, match="no quantized MoE"):
        launcher.main(["--arch", "mixtral_8x7b", "--smoke", "--device", "cpu",
                       "--quantize", "w8a8"])
