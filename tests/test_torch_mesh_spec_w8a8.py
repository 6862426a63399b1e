"""Speculative decoding and W8A8 + int8 KV under the port's (1, 2)
mesh, against the JAX single-device engines (``tests/test_spec_decode.py:464``
and ``tests/test_quantized_ops.py:262``, whose sharded reference fails on
this tree). Ranks are spawned over gloo as in
``tests/test_torch_mesh_serve.py``.
"""
import pytest

from repro_torch.convert import params_from_jax
from repro_torch.launch.mesh import spawn
from tests import _torch_mesh_cases as C
from tests import _torch_mesh_oracle as O


@pytest.fixture(scope="module")
def oracle():
    """The JAX single-device engine's plain-decode tokens on the spec
    requests and its W8A8 + int8 KV tokens, and the weights as numpy
    leaves for the ranks."""
    cfg = O.exact_cfg()
    params = O.params(cfg)
    return {"spec_plain": O.tokens(cfg, params, C.spec_requests(cfg),
                                   decode_horizon=8),
            "w8a8": O.tokens(O.w8a8_cfg(cfg), params, C.w8a8_requests(cfg)),
            "params": O.numpy_params(params)}


def test_spec_decode_under_mesh(oracle):
    """Speculative decoding on a (1, 2) mesh (the n-gram drafter, and a
    draft model sharded by its own rules) gives plain single-device
    decode's tokens (``tests/test_spec_decode.py:464``)."""
    ranks = spawn(C.spec_battery, 2, ((1, 2), oracle["params"]),
                  timeout=C.SPAWN_TIMEOUT)
    for out in ranks:
        for name in ("ngram", "draft"):
            assert out[name] == oracle["spec_plain"], name
            assert out[name + "_stats"]["spec_dispatches"] > 0
        assert out["draft_stats"]["acceptance_rate"] > 0.9


def test_w8a8_mesh_1x2_bitwise(oracle):
    """W8A8 + int8 KV on a (1, 2) mesh: every head's logits bitwise the
    single-device port's (the row-parallel products share one row scale
    and sum int32 partials), the tokens the JAX single-device W8A8
    engine's, and per forward the collectives the plan calls for: the
    embedding, per layer a max and a sum for ``wo`` and for ``down``,
    the head's gather."""
    cfg = C.w8a8_cfg()
    params = params_from_jax(oracle["params"], cfg, "cpu")
    toks, logits = C.single_device(cfg, params, C.w8a8_requests(cfg))
    assert toks == oracle["w8a8"]
    ranks = spawn(C.w8a8_battery, 2, ((1, 2), oracle["params"]),
                  timeout=C.SPAWN_TIMEOUT)
    for out in ranks:
        assert out["tokens"] == toks
        assert len(out["logits"]) == len(logits)
        for a, b in zip(out["logits"], logits):
            assert a.tobytes() == b.tobytes()
        n = cfg.n_layers
        assert out["counts"] == {"all_reduce_sum": 1 + 2 * n,
                                 "all_reduce_max": 2 * n, "all_gather": 1,
                                 "agreed": 1}, out["counts"]
