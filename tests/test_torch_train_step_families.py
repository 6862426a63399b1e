"""One train step of the recurrent, encoder-decoder and vision-language
configs (rwkv6_7b with its (64, 64)-style per-head GroupNorm affine at
smoke size, recurrentgemma_9b, whisper_small, qwen2_vl_7b) through the
port on the CPU against the JAX package, as ``test_torch_train_step.py``
does for the dense and MoE configs (bars in
``tests/_torch_train_cases.py``); remat settings bitwise equal for the
recurrent and encdec forwards.
"""
import pytest

from tests import _torch_train_cases as C
from tests._torch_train_cases import one_torch_thread  # noqa: F401

NAMES = ("rwkv6_7b", "recurrentgemma_9b", "whisper_small", "qwen2_vl_7b")


@pytest.fixture(scope="module", params=NAMES)
def step(request):
    name = request.param
    ref = C.jax_step(name)
    return name, ref, C.port_step(ref, name)


def test_train_step_matches_jax(step):
    name, ref, got = step
    C.check_step(ref, got)


def test_every_leaf_gets_a_gradient(step):
    """No leaf of the masters is cut from the graph: the port's grads
    are non-zero wherever JAX's are."""
    import numpy as np
    name, ref, got = step
    for g, w in zip(got["grads"], ref["grads"]):
        w = np.asarray(w)
        if w.size and np.abs(w).max() > 0:
            assert g.abs().max().item() > 0


@pytest.mark.parametrize("name", ("rwkv6_7b", "recurrentgemma_9b",
                                  "whisper_small"))
def test_remat_settings_give_bitwise_equal_grads(name):
    g = C.remat_grads(name)
    C.assert_bitwise(g["none"], g["dots"])
    C.assert_bitwise(g["none"], g["full"])


def test_masters_view_is_the_serving_tree(step):
    C.check_masters_view(step[0], step[1])
