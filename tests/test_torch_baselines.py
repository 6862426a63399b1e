"""The port's Softermax and I-BERT baselines, the rest of ``core/sole``,
the registry's coverage and the quickstart, against the JAX package on
the CPU. The same numpy inputs go to both sides.

Tolerances, and why:
* I-BERT is integer arithmetic (int32, floor division, a fixed 10-step
  Newton square root): bitwise.
* Softermax rounds ``exp2`` of non-integers to 15 fractional bits; XLA
  and torch may differ by an ulp in ``exp2``, which can move one fixed-
  point step: 2^-15 absolute (the sum is at least 1). On these inputs
  both give the same bits.
* ``e2softmax_online``, ``unpack_e2``: integer codes equal; XLA's CPU
  ``exp2`` of integers is inexact (~5e-7 relative per power of two at
  the 4-bit codes' exponents): 2e-6 relative. ``log2_dequantize`` reaches
  2^-63, where that error grows to ~2e-6: the port's values are exact
  powers of two, and JAX's within 3e-6.
* ``rsqrt_lut`` and ``use_rsqrt_lut``: XLA's CPU ``rsqrt`` is approximate
  (about an ulp): 1e-6 relative.
* quantizer calibration (``calibrate_affine``, ``log2_quantize``,
  ``fake_quant_int8``): bitwise.
* the baseline paged attention (gather, two-pass): float32 sums in
  another order: 1e-5 of the output scale.
"""
import importlib
import runpy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ops as jops
from repro_torch import ops as tops

JI = importlib.import_module("repro.core.baselines.ibert")
JS = importlib.import_module("repro.core.baselines.softermax")
JE = importlib.import_module("repro.core.sole.e2softmax")
JA = importlib.import_module("repro.core.sole.ailayernorm")
JQ = importlib.import_module("repro.core.sole.quant")
TI = importlib.import_module("repro_torch.core.baselines.ibert")
TS = importlib.import_module("repro_torch.core.baselines.softermax")
TE = importlib.import_module("repro_torch.core.sole.e2softmax")
TA = importlib.import_module("repro_torch.core.sole.ailayernorm")
TQ = importlib.import_module("repro_torch.core.sole.quant")


def _logits(seed, shape=(7, 300)):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 4).astype(np.float32)
    mask = rng.random(shape) > 0.2
    mask[0] = False                                   # a fully masked row
    return x, mask


def _j(*a):
    return [jnp.asarray(x) for x in a]


def _t(*a):
    return [torch.from_numpy(np.asarray(x)) for x in a]


# -- baselines ----------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True])
def test_softermax_matches_jax(masked):
    x, mask = _logits(1)
    kw = [dict(mask=m) for m in ((_j(mask)[0], _t(mask)[0]) if masked
                                 else (None, None))]
    want = np.asarray(JS.softermax(*_j(x), **kw[0]))
    got = TS.softermax(*_t(x), **kw[1]).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2.0 ** -15)


@pytest.mark.parametrize("masked", [False, True])
def test_i_softmax_is_bit_exact(masked):
    x, mask = _logits(2)
    kw = [dict(mask=m) for m in ((_j(mask)[0], _t(mask)[0]) if masked
                                 else (None, None))]
    want = np.asarray(JI.i_softmax(*_j(x), **kw[0]))
    np.testing.assert_array_equal(TI.i_softmax(*_t(x), **kw[1]).numpy(),
                                  want)


def test_i_exp_and_poly_are_bit_exact():
    q = -np.arange(0, 2000, 3, dtype=np.int32)
    for scale in (1 / 64, 1 / 16, 0.3):
        for fj, ft in ((JI.i_exp, TI.i_exp), (JI.i_poly_exp, TI.i_poly_exp)):
            qj, sj = fj(*_j(q), scale)
            qt, st = ft(*_t(q), scale)
            assert sj == st
            np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))


def test_i_sqrt_and_bit_length_are_bit_exact():
    rng = np.random.default_rng(3)
    n = np.concatenate([np.arange(0, 70), rng.integers(0, 2 ** 31 - 1, 2000),
                        2 ** np.arange(31) - 1]).astype(np.int32)
    np.testing.assert_array_equal(TI._bit_length(*_t(n)).numpy(),
                                  np.asarray(JI._bit_length(*_j(n))))
    np.testing.assert_array_equal(TI.i_sqrt(*_t(n)).numpy(),
                                  np.asarray(JI.i_sqrt(*_j(n))))


@pytest.mark.parametrize("amp", [1.0, 30.0])
def test_i_layernorm_is_bit_exact(amp):
    """``amp`` 30 drives the int32 variance past 2^31, where both wrap."""
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((6, 768)) * amp + 0.5).astype(np.float32)
    g = (1 + 0.1 * rng.standard_normal(768)).astype(np.float32)
    b = (0.1 * rng.standard_normal(768)).astype(np.float32)
    np.testing.assert_array_equal(TI.i_layernorm(*_t(x, g, b)).numpy(),
                                  np.asarray(JI.i_layernorm(*_j(x, g, b))))


# -- the registry ---------------------------------------------------------------


def _pairs():
    return [(op, mode) for op in jops.OPS for mode in jops.MODES_BY_OP[op]]


def test_registry_parity_with_the_jax_package():
    """Every (op, mode) the JAX package registers under ``reference`` the
    port registers under ``reference``; every one it runs through a
    Pallas kernel has a port ``cuda`` entry, which the card resolves."""
    assert tops.OPS == jops.OPS and tops.MODES_BY_OP == jops.MODES_BY_OP
    ref = [p for p in _pairs() if jops.is_registered(*p, "reference")]
    pallas = [p for p in _pairs() if jops.is_registered(*p, "pallas")]
    assert len(ref) == len(_pairs()) and len(pallas) == 12
    assert [p for p in ref if not tops.is_registered(*p, "reference")] == []
    assert [p for p in pallas if not tops.is_registered(*p, "cuda")] == []
    for op, mode in pallas:
        assert tops.backend_for(op, mode, "cuda") == "cuda"
    for op, mode in _pairs():
        assert tops.backend_for(op, mode, "cpu") == "reference"


@pytest.mark.parametrize("mode", ["softermax", "ibert"])
def test_baseline_softmax_ops(mode):
    x, mask = _logits(5, (3, 4, 50))
    want = jops.softmax_fn(mode, backend="reference")(*_j(x),
                                                      mask=_j(mask)[0])
    got = tops.softmax_fn(mode, "cpu")(*_t(x), mask=_t(mask)[0])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2.0 ** -15)


@pytest.mark.parametrize("quant_out", [False, True])
@pytest.mark.parametrize("kind", ["layernorm", "rmsnorm"])
def test_ibert_norm_ops(kind, quant_out):
    """I-BERT norms, alone and as the residual twins (and their int8
    quantize-out), bitwise against the jitted JAX ops (the port's
    ``quantize_act`` takes the jitted scale, ``amax * float32(1/127)``)."""
    rng = np.random.default_rng(6)
    x, r = (rng.standard_normal((2, 5, 96)).astype(np.float32) * 3
            for _ in range(2))
    g = (1 + 0.1 * rng.standard_normal(96)).astype(np.float32)
    b = (0.1 * rng.standard_normal(96)).astype(np.float32)
    extra = (b,) if kind == "layernorm" else ()
    want = getattr(jops, f"{kind}_fn")("ibert", backend="reference")(
        *_j(x, g, *extra))
    got = getattr(tops, f"{kind}_fn")("ibert", "cpu")(*_t(x, g, *extra))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    jfn = (jops.residual_norm_q_fn if quant_out else jops.residual_norm_fn)
    tfn = (tops.residual_norm_q_fn if quant_out else tops.residual_norm_fn)
    jh, jo = jax.jit(jfn(kind, "ibert", backend="reference"))(
        *_j(x, r, g, *extra))
    th, to = tfn(kind, "ibert", "cpu")(*_t(x, r, g, *extra))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    for a, bb in zip(to if quant_out else (to,), jo if quant_out else (jo,)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(bb))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("mode", ["softermax", "ibert"])
def test_baseline_paged_attention(mode, causal):
    """The gather-and-two-pass paged attention of the baseline modes over
    a shuffled pool, GQA 4:2, a prefill chunk at q_start 5, ragged kv."""
    rng = np.random.default_rng(7)
    b, c, h, kvh, hd, bs, nb = 2, 4, 4, 2, 16, 8, 3
    n = b * nb + 1
    q = rng.standard_normal((b, c, h, hd)).astype(np.float32)
    pk, pv = (rng.standard_normal((n, bs, kvh, hd)).astype(np.float32)
              for _ in range(2))
    tables = (rng.permutation(n - 1)[:b * nb] + 1).reshape(b, nb) \
        .astype(np.int32)
    q_start = np.array([5, 0], np.int32)
    kv_len = np.array([9, 20], np.int32)
    args = (q, pk, pv, tables, q_start, kv_len)
    want = jops.paged_attention_fn(mode, backend="reference")(
        *_j(*args), causal=causal)
    got = tops.paged_attention_fn(mode, "cpu")(*_t(*args), causal=causal)
    scale = max(float(np.abs(np.asarray(want)).max()), 1.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5 * scale)


# -- the rest of core/sole --------------------------------------------------------


@pytest.mark.parametrize("block", [64, 128])
@pytest.mark.parametrize("masked", [False, True])
def test_e2softmax_online_matches_jax(block, masked):
    x, mask = _logits(8)
    mj, mt = (_j(mask)[0], _t(mask)[0]) if masked else (None, None)
    want = np.asarray(JE.e2softmax_online(*_j(x), block=block, mask=mj))
    got = TE.e2softmax_online(*_t(x), block=block, mask=mt).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=0)


def test_pack_and_unpack_e2():
    rng = np.random.default_rng(9)
    k = rng.integers(-3, 40, 500).astype(np.int32)
    q = rng.integers(0, 2, 500).astype(bool)
    want = np.asarray(JE.pack_e2(*_j(k, q)))
    got = TE.pack_e2(*_t(k, q))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_allclose(TE.unpack_e2(got).numpy(),
                               np.asarray(JE.unpack_e2(jnp.asarray(want))),
                               rtol=2e-6)


def test_rsqrt_lut_matches_jax():
    rng = np.random.default_rng(10)
    v = (10.0 ** rng.uniform(-3, 7, 20000)).astype(np.float32)
    v = np.concatenate([v, 4.0 ** np.arange(-5, 6), [0.0, 1e-14]]) \
        .astype(np.float32)
    np.testing.assert_allclose(TA.rsqrt_lut(*_t(v)).numpy(),
                               np.asarray(JA.rsqrt_lut(*_j(v))), rtol=1e-6)


@pytest.mark.parametrize("kind", ["layernorm", "rmsnorm"])
def test_use_rsqrt_lut(kind):
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((8, 128)) * 2).astype(np.float32)
    g = (1 + 0.1 * rng.standard_normal(128)).astype(np.float32)
    b = (0.1 * rng.standard_normal(128)).astype(np.float32)
    extra = (b,) if kind == "layernorm" else ()
    fj = getattr(JA, "ailayernorm" if kind == "layernorm" else "airmsnorm")
    ft = getattr(TA, "ailayernorm" if kind == "layernorm" else "airmsnorm")
    want = np.asarray(fj(*_j(x, g, *extra), use_rsqrt_lut=True))
    got = ft(*_t(x, g, *extra), use_rsqrt_lut=True).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    plain = ft(*_t(x, g, *extra)).numpy()
    assert np.abs(got - plain).max() > 0          # the LUT is coarser


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("symmetric", [True, False])
def test_affine_quantizer_matches_jax(symmetric, dtype):
    rng = np.random.default_rng(12)
    x = (rng.standard_normal((16, 96)) * 3 + 0.4).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.dtype(dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    pj = JQ.calibrate_affine(jx, symmetric=symmetric)
    pt = TQ.calibrate_affine(tx, symmetric=symmetric)
    assert pt.scale.dtype == tx.dtype
    assert float(pj.scale) == pt.scale.float().item()
    assert int(pj.zero_point) == pt.zero_point.item()
    for unsigned in (False, True):
        np.testing.assert_array_equal(
            pt.quantize(tx, unsigned=unsigned).numpy(),
            np.asarray(pj.quantize(jx, unsigned=unsigned)))
    np.testing.assert_array_equal(
        TQ.fake_quant_int8(tx, symmetric=symmetric).float().numpy(),
        np.asarray(JQ.fake_quant_int8(jx, symmetric=symmetric)
                   .astype(jnp.float32)))


def test_log2_quantizer_matches_jax():
    rng = np.random.default_rng(13)
    x = np.concatenate([rng.random(5000), 2.0 ** -np.arange(20),
                        [0.0, 1.0]]).astype(np.float32)
    for bits in (4, 6):
        np.testing.assert_array_equal(
            TQ.log2_quantize(*_t(x), bits).numpy(),
            np.asarray(JQ.log2_quantize(*_j(x), bits)))
    k = np.arange(0, 64, dtype=np.int32)
    got = TQ.log2_dequantize(*_t(k)).numpy()
    np.testing.assert_array_equal(got, np.ldexp(np.float32(1), -k))
    # XLA's CPU exp2 of integers drifts with |k| (2.03e-6 at k = 61)
    np.testing.assert_allclose(got, np.asarray(JQ.log2_dequantize(*_j(k))),
                               rtol=3e-6)


def test_quickstart_prints_the_reference_lines(capsys):
    """``repro_torch.launch.quickstart --device cpu`` takes the example's
    steps on the same inputs and prints the same lines; only the line
    naming the kernel says which it ran."""
    runpy.run_path("examples/quickstart.py", run_name="__main__")
    want = capsys.readouterr().out.splitlines()
    from repro_torch.launch import quickstart
    assert quickstart.main(["--device", "cpu"]) == 0
    got = capsys.readouterr().out.splitlines()
    assert len(got) == len(want)
    for a, b in zip(got, want):
        if "max |diff|" in b:
            assert a.split("=")[1] == b.split("=")[1]
        else:
            assert a == b
