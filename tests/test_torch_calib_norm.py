"""The calibrating AILayerNorm (``kernels.ailayernorm.calibrated_norm``:
residual add, PTF calibration over all rows and the quantize+norm in one
kernel launch on the card) against the JAX package's ``params=None``
paths: ``fused_add_norm_pallas``, ``fused_add_norm_quant_pallas``,
``ailayernorm_pallas`` and ``airmsnorm_pallas`` in interpret mode.

On CPU tensors the wrapper computes its plain version, the torch chain the
kernel replaces; the card tests hold the kernel to that chain bit for bit.

Tolerances, and why:
* ``h``, ``alpha`` and ``scale``: one add, then max/divide/log2/ceil in
  the activation dtype on both sides: equal, and equal to the port's own
  ``calibrate_ptf`` of ``h``.
* the norm output: integer codes and sums are exact on both sides, the
  float epilogue takes the compiled call's forms and differs by XLA's
  approximate CPU ``rsqrt``: 1e-6, as ``test_norm_matches_pallas``.
* quantize-out: the codes and row scales equal the port's ``quantize_act``
  of its float32 output bit for bit; against JAX, whose output differs in
  the last bit (above), the scale agrees to 3e-7 and at least 99% of the
  codes are equal, as ``test_fused_quant_out_static_params``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.sole.quant import calibrate_ptf as j_calibrate
from repro.kernels import ailayernorm as JK  # repro: noqa RPR001
from repro_torch import ops as tops
from repro_torch.core.sole.quant import calibrate_ptf, quantize_act
from repro_torch.kernels import ailayernorm as KN


def _inputs(rows, c, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, c)).astype(np.float32) * 2
    x *= 2.0 ** rng.integers(0, 4, size=c)            # every PTF alpha
    r = rng.standard_normal((rows, c)).astype(np.float32)
    gamma = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(c)).astype(np.float32)
    return x, r, gamma, beta


@pytest.mark.parametrize("c", [64, 896])
@pytest.mark.parametrize("rows", [1, 8, 128])
@pytest.mark.parametrize("residual", [False, True], ids=["norm", "residual"])
@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_calibrated_norm_matches_pallas(dtype, kind, residual, rows, c):
    rms = kind == "rmsnorm"
    x, r, gamma, beta = _inputs(rows, c, seed=rows + c + rms + 2 * residual)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jx, jr = jnp.asarray(x).astype(jdt), jnp.asarray(r).astype(jdt)
    tx, tr = (torch.from_numpy(a).to(tdt) for a in (x, r))
    tg, tb = torch.from_numpy(gamma), torch.from_numpy(beta)
    jb = None if rms else jnp.asarray(beta)
    if residual:
        jh, jout = JK.fused_add_norm_pallas(jx, jr, jnp.asarray(gamma), jb,
                                            rms=rms, interpret=None)
        jparams = j_calibrate(jx + jr, unsigned=not rms)
    elif rms:
        jh, jout = jx, JK.airmsnorm_pallas(jx, jnp.asarray(gamma),
                                           interpret=None)
        jparams = j_calibrate(jx, unsigned=False)
    else:
        jh, jout = jx, JK.ailayernorm_pallas(jx, jnp.asarray(gamma), jb,
                                             interpret=None)
        jparams = j_calibrate(jx, unsigned=True)
    before = KN.calibrated_norm.launches
    h, out, alpha, scale = KN.calibrated_norm(
        tx, tr if residual else None, tg, None if rms else tb, rms=rms)
    assert KN.calibrated_norm.launches == before      # CPU tensors: plain
    assert h.dtype == tdt and out.dtype == torch.float32
    np.testing.assert_array_equal(h.float().numpy(),
                                  np.asarray(jh, np.float32))
    np.testing.assert_array_equal(alpha.numpy(), np.asarray(jparams.alpha))
    assert scale.item() == float(jparams.scale)
    tp = calibrate_ptf(h, unsigned=not rms)
    assert torch.equal(alpha, tp.alpha) and scale.item() == tp.scale.item()
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-6,
                               atol=1e-6)
    # the model dtype out: the float32 output rounded once
    _, out_t, _, _ = KN.calibrated_norm(
        tx, tr if residual else None, tg, None if rms else tb, rms=rms,
        out_dtype=tdt)
    assert out_t.dtype == tdt and torch.equal(out_t, out.to(tdt))
    if not residual:
        return
    h2, (codes, qscale), alpha2, _ = KN.calibrated_norm(
        tx, tr, tg, None if rms else tb, rms=rms, quant_out=True)
    want_codes, want_scale = quantize_act(out)
    assert torch.equal(h2, h) and torch.equal(alpha2, alpha)
    assert torch.equal(codes, want_codes) and torch.equal(qscale, want_scale)
    _, (jq, js) = JK.fused_add_norm_quant_pallas(
        jx, jr, jnp.asarray(gamma), jb, rms=rms, interpret=None)
    np.testing.assert_allclose(qscale.numpy(), np.asarray(js), rtol=3e-7)
    assert (codes.numpy() == np.asarray(jq)).mean() >= 0.99


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_cuda_adapters_reach_the_calibrating_norm(kind):
    """Without params the cuda adapters (plain versions on CPU tensors)
    give the calibrating norm's results, in a (..., C) shape, with the
    output in ``out_dtype`` where the model asks for it."""
    rms = kind == "rmsnorm"
    x, r, gamma, beta = _inputs(6, 64, seed=5)
    tx, tr = (torch.from_numpy(a).reshape(2, 3, 64).bfloat16()
              for a in (x, r))
    tg, tb = torch.from_numpy(gamma), torch.from_numpy(beta)
    extra = () if rms else (tb,)
    flat = [None if t is None else t.reshape(6, 64) for t in (tx, tr)]
    h, out, _, _ = KN.calibrated_norm(*flat, tg, None if rms else tb, rms=rms)
    got = tops.resolve(kind, "sole", "cuda")(tx, tg, *extra)
    assert torch.equal(got, KN.calibrated_norm(flat[0], None, tg,
                                               None if rms else tb,
                                               rms=rms)[1].reshape(2, 3, 64))
    gh, gout = tops.resolve(f"residual_{kind}", "sole", "cuda")(
        tx, tr, tg, *extra, out_dtype=torch.bfloat16)
    assert torch.equal(gh, h.reshape(2, 3, 64))
    assert gout.dtype == torch.bfloat16
    assert torch.equal(gout, out.reshape(2, 3, 64).bfloat16())
    qh, (codes, scale) = tops.resolve(f"residual_{kind}_q", "sole", "cuda")(
        tx, tr, tg, *extra)
    assert torch.equal(qh, gh) and scale.shape == (2, 3, 1)
    assert all(torch.equal(a, b.reshape(a.shape))
               for a, b in zip((codes, scale), quantize_act(out)))
