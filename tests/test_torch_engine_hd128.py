"""The paged-engine parity trace of ``tests/test_torch_engine.py`` on
minitron_8b's smoke config at head dim 128 (``d^-1/2`` no
power of two) (one file per config, so the tier-1 workers share the traces).
"""
import pytest

from _torch_engine_cases import engine_case, jax_params_of


@pytest.fixture(scope="module")
def jax_params():
    return jax_params_of(("minitron_8b-hd128",))


@pytest.mark.parametrize("mode", ["exact", "sole"])
@pytest.mark.parametrize("name", ["minitron_8b-hd128"])
def test_engine_matches_jax_engine(name, mode, jax_params, monkeypatch):
    engine_case(name, mode, jax_params, monkeypatch)
