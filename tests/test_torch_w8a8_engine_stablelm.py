"""The port's W8A8 and W8A16 ``PagedEngine`` against the JAX package's on
the stablelm_1_6b smoke config (LayerNorm, 2,048 wide at full width): the
tests of ``tests/test_torch_w8a8_engine.py``, whose docstring says what
each asserts, for this config (shared set-up in
``tests/_torch_w8a8_cases.py``).
"""
import pytest

from _torch_w8a8_cases import jax_params_of, w8a16_case, w8a8_case

NAME = "stablelm_1_6b"


@pytest.fixture(scope="module")
def jax_params():
    return jax_params_of(NAME)


@pytest.mark.parametrize("kv", ["auto", "int8"])
@pytest.mark.parametrize("mode", ["exact", "sole"])
@pytest.mark.parametrize("name", [NAME])
def test_w8a8_engine_matches_jax_engine(name, mode, kv, jax_params,
                                        monkeypatch):
    w8a8_case(name, mode, kv, jax_params, monkeypatch)


@pytest.mark.parametrize("name", [NAME])
def test_w8a16_engine_matches_jax_engine(name, jax_params):
    w8a16_case(name, jax_params)
