"""The port's W8A8 ``PagedEngine`` on the CPU against the JAX
``PagedEngine`` (paged attention through its Pallas kernel in interpret
mode), on the qwen2 smoke config here and the stablelm one in
``tests/test_torch_w8a8_engine_stablelm.py`` (the same tests; shared
set-up in ``tests/_torch_w8a8_cases.py``), with the same float32 master
weights: both engines pack the int8 codes themselves.

Each trace is the one of ``tests/test_torch_engine.py``: five greedy
prompts (one longer than two prefill chunks, two sharing a 16-token
prefix, 8 new tokens, decode horizon 4), then a repeat of a wave-1 prompt
with an eos id from the JAX engine's output and a new prompt on the shared
prefix; ``check_refcounts`` after each wave.

* w8a8, with float KV pages ("auto") and with int8 KV pages:
  - exact mode: greedy tokens and finish reasons equal; the int32 sums
    make the port's decode horizon 1 equal its horizon 8.
  - SOLE mode: tokens equal, and every ``prefill_paged`` /
    ``decode_step_paged`` call the port made, replayed through the JAX
    model on the same inputs and pools, gives logits within 1e-4 in at
    least 95% of the calls. For the replay the JAX norms take a correctly
    rounded ``1 / sqrt`` in place of ``jax.lax.rsqrt``: XLA's CPU rsqrt is
    approximate (it differs from ``1 / sqrt`` on ~36% of float32 inputs),
    and at w8a8 that last bit matters. A SOLE norm's output is an integer
    code times one row factor, so its per-row int8 codes land exactly on
    rounding ties (~2.5% of elements on the qwen2 trace) and the last bit
    of the row factor decides them; one flipped activation code moves
    logits by ~1e-2. With XLA's rsqrt the qwen2 trace agrees in only
    19-36% of its calls; with ``1 / sqrt`` in 98-100%, the rest being the
    one-ulp flips of a PTF or activation code that the float trace of
    ``tests/test_torch_engine.py`` shows too.
* w8a16, exact mode: tokens equal.
* quant off: the float path is untouched (no packed leaf, no int8 GEMM
  call) and its tokens equal the JAX engine's.
"""
import jax
import pytest
import torch

from _torch_w8a8_cases import (_engines, _serve, _waves, _both_waves,
                               jax_params_of, w8a16_case, w8a8_case)
from repro.serve.engine import Request as JaxRequest
from repro_torch.core.sole.quant import is_qtensor
from repro_torch.kernels import int8_matmul as KM
from repro_torch.serve.engine import Request

NAME = "qwen2_0_5b"


@pytest.fixture(scope="module")
def jax_params():
    return jax_params_of(NAME)


@pytest.mark.parametrize("kv", ["auto", "int8"])
@pytest.mark.parametrize("mode", ["exact", "sole"])
@pytest.mark.parametrize("name", [NAME])
def test_w8a8_engine_matches_jax_engine(name, mode, kv, jax_params,
                                        monkeypatch):
    w8a8_case(name, mode, kv, jax_params, monkeypatch)


@pytest.mark.parametrize("kv", ["auto", "int8"])
def test_w8a8_decode_horizon_invariant(kv, jax_params):
    """Exact mode: the port's horizon-1 and horizon-8 engines give the
    same tokens (every w8a8 sum is an exact int32 sum), equal to the JAX
    engine's at horizon 8."""
    outs = []
    for horizon in (1, 8):
        _, tcfg, jeng, teng = _engines(NAME, "exact", "w8a8", kv,
                                       jax_params, decode_horizon=horizon)
        prompts, _ = _waves(tcfg.vocab_size, seed=3)
        outs.append(_serve(teng, Request, prompts, None, None))
        teng.cache.check_refcounts()
    assert outs[0] == outs[1]
    assert outs[1] == _serve(jeng, JaxRequest, prompts, None, None)


@pytest.mark.parametrize("name", [NAME])
def test_w8a16_engine_matches_jax_engine(name, jax_params):
    w8a16_case(name, jax_params)


def test_quant_off_path_unchanged(jax_params):
    """quant "off": float weights, no packed leaf, no int8 GEMM call, and
    the JAX engine's tokens."""
    _, tcfg, jeng, teng = _engines(NAME, "exact", "off", "auto", jax_params)
    flat = jax.tree_util.tree_leaves(teng.params)
    assert all(t.dtype == torch.float32 for t in flat)
    assert not is_qtensor(teng.params["embed"]["head"])
    before = KM.int8_matmul.launches
    prompts, tail = _waves(tcfg.vocab_size, seed=5)
    jout, tout, _ = _both_waves(jeng, teng, prompts, tail)
    assert tout == jout
    assert KM.int8_matmul.launches == before
