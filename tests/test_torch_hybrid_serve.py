"""The hybrid family (``recurrentgemma_9b`` smoke at 4 layers, one tail
layer: slot state for the RG-LRU layers, paged K/V for the attention
block) through the port's ``PagedEngine``, dense-slot ``Engine`` and
``AsyncEngine`` on the CPU against the JAX package's engines on the same
weights: the reference's multi-family serve cases
(``tests/test_multiarch_serve.py``) token for token in exact mode, with
every serving counter both report, including the joint page + slot resume
and recompute-preemption; SOLE mode at least 95% of tokens equal. The
cases: ``tests/_torch_recurrent_cases.py``.
"""
import pytest

import _torch_recurrent_cases as C


@pytest.fixture(scope="module")
def fam():
    return C.Fam("hybrid")


@pytest.mark.parametrize("case", ["cold_vs_dense", "warm_prefix", "preempt",
                                  "eos", "async_loop", "o1_state",
                                  "sole_agreement", "capability_errors"])
def test_hybrid_serve_matches_jax(case, fam):
    getattr(C, case)(fam)
