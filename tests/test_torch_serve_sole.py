"""``repro_torch.launch.serve_sole`` on the CPU against the JAX example
``examples/serve_sole.py`` on the same weights (JAX ``init_params`` at
seed 0, converted through numpy) and the same trace, with the reference
backend on both sides (the example's ``--backend reference``; its dense
``Engine`` resolves ``auto`` to the reference backend on the CPU).

The example is a script whose ``main()`` returns nothing, so its engine
runs are rebuilt here with its settings (``examples/serve_sole.py:38-58``:
twelve prompts of 8-12 tokens from ``default_rng(0)``, 12 new tokens,
``PagedEngine`` over 48 pages of 8 with ``max_seq_len`` 64, 8 running,
decode batches of 4, chunks of 8; ``Engine`` with batches of 4 and
64-column caches), which the launcher must share.

Exact mode: both engines' greedy tokens equal. SOLE mode (the example's
own mode): the greedy tokens equal, the engine tests' token bar (a code
flip there would move the logits by ~1e-2 and is allowed by their
per-call bar, not by this one, so the trace is held to equality).
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro.configs.base import get_config as jax_config
from repro.models import api as japi
from repro.serve.engine import Engine as JaxEngine
from repro.serve.engine import PagedEngine as JaxPagedEngine
from repro.serve.engine import Request as JaxRequest
from repro_torch.configs.base import get_config
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve_sole

EXACT = dict(softmax_mode="exact", norm_mode="exact", logit_int8=False)


def _jax_example(cfg, params, n=12, new=12):
    """The example's two engine runs (``--backend reference --dense``)."""
    rng = np.random.default_rng(0)
    reqs = [JaxRequest(prompt=rng.integers(0, cfg.vocab_size, size=8 + i % 5)
                       .astype(np.int32), max_new_tokens=new)
            for i in range(n)]
    eng = JaxPagedEngine(cfg, params, num_blocks=48, block_size=8,
                         max_seq_len=64, max_running=8, decode_batch=4,
                         prefill_chunk=8, backend="reference")
    paged = eng.generate(reqs)
    dense = JaxEngine(cfg, params, batch_size=4, max_len=64).generate(reqs)
    return ([list(map(int, o)) for o in paged],
            [list(map(int, o)) for o in dense])


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_config("qwen2_0_5b").smoke()
    return japi.init_params(jax.random.PRNGKey(0), jcfg)[0]


def test_launcher_shares_the_example_settings():
    assert serve_sole.PAGED == dict(num_blocks=48, block_size=8,
                                    max_seq_len=64, max_running=8,
                                    decode_batch=4, prefill_chunk=8)
    assert serve_sole.DENSE == dict(batch_size=4, max_len=64)
    reqs = serve_sole.requests(get_config("qwen2_0_5b").smoke(), 12, 12)
    assert [len(r.prompt) for r in reqs] == [8 + i % 5 for i in range(12)]


@pytest.mark.parametrize("mode", ["exact", "sole"])
def test_serve_sole_tokens_match_jax_example(weights, mode):
    over = EXACT if mode == "exact" else {}
    jcfg = dataclasses.replace(jax_config("qwen2_0_5b").smoke(), **over)
    cfg = dataclasses.replace(get_config("qwen2_0_5b").smoke(), **over)
    j_paged, j_dense = _jax_example(jcfg, weights)
    out = serve_sole.main(["--device", "cpu", "--backend", "reference",
                           "--dense"], cfg=cfg,
                          params=params_from_jax(weights, cfg, "cpu"))
    assert [len(o) for o in out["paged"]] == [12] * 12
    assert out["paged"] == j_paged
    assert out["dense"] == j_dense
    assert out["paged_tokens"] == out["dense_tokens"] == 144
    assert 0 < out["peak_pages"] <= 47 and out["steps"] > 0


def test_serve_sole_cli_on_cpu(capsys):
    """The launcher's own weights (``init_params`` at seed 0), ``auto``
    backend: every request gets its tokens, the example's lines print."""
    out = serve_sole.main(["--device", "cpu", "--requests", "4",
                           "--new-tokens", "3"])
    assert [len(o) for o in out["paged"]] == [3] * 4
    text = capsys.readouterr().out
    assert "paged[auto]: 4 requests, 12 tokens" in text
    assert "sample continuations:" in text
