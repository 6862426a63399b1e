"""The MoE family (``mixtral_8x7b``, ``dbrx_132b`` smoke configs: 4
experts, top-2) through the port's ``PagedEngine`` on the CPU against the
JAX package's, on the same weights: the two-wave trace of
``tests/test_torch_engine.py`` (a cold wave, then a warm prefix-cache
replay with an eos finish; ``_torch_engine_cases``). Exact mode: greedy
tokens equal. SOLE mode: tokens equal and at least 95% of the recorded
model calls within 1e-4 of the JAX model's logits. The port against
itself and the host-side traces: ``tests/test_torch_moe_host.py``.
"""
import pytest

from _torch_engine_cases import engine_case, jax_params_of

ARCHS = ("mixtral_8x7b", "dbrx_132b")


@pytest.fixture(scope="module")
def jax_params():
    return jax_params_of(ARCHS)


@pytest.mark.parametrize("mode", ["exact", "sole"])
@pytest.mark.parametrize("name", ARCHS)
def test_engine_matches_jax_engine(name, mode, jax_params, monkeypatch):
    engine_case(name, mode, jax_params, monkeypatch)
