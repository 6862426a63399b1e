"""One train step of the dense and MoE configs through the port on the
CPU against the JAX package (``jax.value_and_grad(api.loss_fn)`` and
``adamw_update``, jitted), from the JAX ``init_params`` weights as float32
masters and one seeded ``make_batch`` (``tests/_torch_train_cases.py``
states the float32 bars). Also: qwen2 and stablelm with bf16 compute
(the serving-dtype view of float32 masters, the reference's per-use
cast), held to looser bars: bf16 products round where the two frameworks
place their casts apart; and remat ``none``/``dots``/``full`` giving
bitwise equal gradients.
"""
import pytest

from tests import _torch_train_cases as C
from tests._torch_train_cases import one_torch_thread  # noqa: F401

NAMES = ("qwen2_0_5b", "stablelm_1_6b", "nemotron_4_15b", "minitron_8b",
         "mixtral_8x7b", "dbrx_132b")
# bf16 compute: loss within 1e-3 relative, each gradient leaf within 5e-2
# of its largest magnitude, grad norm within 2e-3, params after one update
# within 1e-5: the bf16 roundings move a gradient by a few bf16 ulps (the
# worst leaf, a small bias gradient, 3.3e-2; the loss 1.1e-4), and an
# element whose tiny gradient changes sign moves by 2 x lr(1) = 6e-6
BF16_BARS = dict(loss_rtol=1e-3, grad_rtol=5e-2, gnorm_rtol=2e-3,
                 param_atol=1e-5)


@pytest.fixture(scope="module", params=NAMES)
def step(request):
    name = request.param
    ref = C.jax_step(name)
    return name, ref, C.port_step(ref, name)


def test_train_step_matches_jax(step):
    name, ref, got = step
    C.check_step(ref, got)


def test_moe_aux_loss_enters_the_loss(step):
    """MoE adds ``AUX_LOSS_WEIGHT * aux`` (the Switch load-balance loss,
    the mean over layers); the dense families' aux is 0."""
    name, ref, got = step
    from repro_torch.models import api
    moe = name in ("mixtral_8x7b", "dbrx_132b")
    assert (got["metrics"]["aux"] > 0) == moe
    want = got["metrics"]["xent"] + api.AUX_LOSS_WEIGHT * got["metrics"]["aux"]
    assert abs(got["loss"] - want) <= 1e-6 * abs(want)


@pytest.mark.parametrize("name", ("qwen2_0_5b", "stablelm_1_6b"))
def test_train_step_bf16_compute(name):
    ref = C.jax_step(name, dtype="bfloat16")
    got = C.port_step(ref, name, dtype="bfloat16")
    C.check_step(ref, got, **BF16_BARS)


@pytest.mark.parametrize("name", ("qwen2_0_5b", "mixtral_8x7b"))
def test_remat_settings_give_bitwise_equal_grads(name):
    g = C.remat_grads(name)
    C.assert_bitwise(g["none"], g["dots"])
    C.assert_bitwise(g["none"], g["full"])



def test_masters_view_is_the_serving_tree(step):
    C.check_masters_view(step[0], step[1])
