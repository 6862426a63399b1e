"""The ssm family (``rwkv6_7b`` smoke: O(1) slot state, no pages) through
the port's ``PagedEngine``, dense-slot ``Engine`` and ``AsyncEngine`` on
the CPU against the JAX package's engines on the same weights: the
reference's multi-family serve cases (``tests/test_multiarch_serve.py``)
token for token in exact mode, with every serving counter both report;
SOLE mode at least 95% of tokens equal. The cases:
``tests/_torch_recurrent_cases.py``.
"""
import pytest

import _torch_recurrent_cases as C


@pytest.fixture(scope="module")
def fam():
    return C.Fam("ssm")


@pytest.mark.parametrize("case", ["cold_vs_dense", "warm_prefix", "eos",
                                  "async_loop", "o1_state", "sole_agreement",
                                  "capability_errors"])
def test_ssm_serve_matches_jax(case, fam):
    getattr(C, case)(fam)
