"""The paged-engine parity trace of ``tests/test_torch_engine.py`` on
stablelm_1_6b's smoke config (SwiGLU, LayerNorm) (one file per config, so the tier-1 workers share the traces).
"""
import pytest

from _torch_engine_cases import engine_case, jax_params_of


@pytest.fixture(scope="module")
def jax_params():
    return jax_params_of(("stablelm_1_6b",))


@pytest.mark.parametrize("mode", ["exact", "sole"])
@pytest.mark.parametrize("name", ["stablelm_1_6b"])
def test_engine_matches_jax_engine(name, mode, jax_params, monkeypatch):
    engine_case(name, mode, jax_params, monkeypatch)
