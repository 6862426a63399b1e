"""The port's SOLE norms with static PTF params — the quantize+norm, the
fused add+norm and add+norm+quantize-out — and AILayerNorm on integer
codes, against the JAX package's Pallas kernels on the CPU.

The port's ``cuda`` adapters hand CPU tensors to the kernel wrappers,
which compute the kernels' plain versions; the JAX side runs its Pallas
kernels in interpret mode (``repro.ops.*_fn(..., backend="pallas")``, the
codes kernel through ``ailayernorm_pallas_codes`` as the JAX package's
own tests reach it). The params are calibrated once on a held-out batch
(the serving configuration) and handed to both sides; their scale and
alpha bits are equal on both.

Tolerances, and why:
* ``h = x + r``: one float32 add on both sides: bitwise.
* norm outputs: codes and int32 sums are exact on both sides; the float
  epilogue takes the compiled call's forms (multiplies by ``1/C``, fused
  multiply-adds) and differs by XLA's approximate CPU ``rsqrt``: 1e-6 of
  the output scale.
* quantize-out: the port's codes and scale are bitwise equal to its own
  ``quantize_act`` of the add+norm output; against JAX, whose norm output
  differs in the last bit (above), the scale agrees to 3e-7 relative and
  at least 99% of the codes are equal.
* the codes kernel against the oracles: as the norm outputs, 1e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ops as jops
from repro.core.sole.quant import calibrate_ptf as j_calibrate_ptf
from repro.kernels.ailayernorm import ailayernorm_pallas_codes  # repro: noqa RPR001
from repro.ops import oracles as jor
from repro_torch import ops as tops
from repro_torch.core.sole.quant import calibrate_ptf, quantize_act
from repro_torch.kernels import ailayernorm as KN
from repro_torch.ops import oracles as tor
from repro_torch.roofline.cost import CostCounter


def _case(seed, shape):
    rng = np.random.default_rng(seed)
    c = shape[-1]

    def acts():
        x = rng.standard_normal(shape).astype(np.float32) * 2
        return x * (2.0 ** rng.integers(0, 4, size=c)).astype(np.float32)

    x, held_out = acts(), acts()
    r = rng.standard_normal(shape).astype(np.float32)
    gamma = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(c)).astype(np.float32)
    return x, r, held_out, gamma, beta


def _params(held_out, unsigned):
    jp = j_calibrate_ptf(jnp.asarray(held_out), unsigned=unsigned)
    tp = calibrate_ptf(torch.from_numpy(held_out), unsigned=unsigned)
    assert float(jp.scale) == tp.scale.item()
    np.testing.assert_array_equal(np.asarray(jp.alpha), tp.alpha.numpy())
    return jp, tp


def _close(got, want, rel=1e-6):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * scale)


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_sole_norm_cuda_adapter_honours_static_params(kind):
    """``layernorm``/``rmsnorm`` sole on the cuda backend run the
    quantize+norm with the caller's params, as the reference and the JAX
    Pallas adapter do (they used to be dropped and recalibrated on the
    call's own batch): the output equals the quantize+norm's plain version
    on those params exactly. (The eager reference backend keeps true
    divisions by C and separately rounded products, where the kernel
    follows the compiled Pallas call; the two differ by a few ulps.)"""
    x, _, held_out, gamma, beta = _case(1, (16, 896))
    jp, tp = _params(held_out, kind == "layernorm")
    extra = (beta,) if kind == "layernorm" else ()
    args = [torch.from_numpy(a) for a in (x, gamma) + extra]
    got = tops.resolve(kind, "sole", "cuda")(*args, params=tp)
    want = KN.qnorm_plain(args[0], tp.scale, tp.alpha, args[1],
                          args[2] if extra else torch.zeros_like(args[1]),
                          rms=kind == "rmsnorm")
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    jfn = getattr(jops, f"{kind}_fn")("sole", backend="pallas")
    _close(got.numpy(), jfn(*(jnp.asarray(a) for a in (x, gamma) + extra),
                            params=jp))
    recal = tops.resolve(kind, "sole", "cuda")(*args)
    assert (recal - got).abs().max().item() > 1e-3   # the params matter here


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(6, 64), (2, 3, 896)])
@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_fused_add_norm_static_params_matches_pallas(kind, shape, dtype):
    x, r, held_out, gamma, beta = _case(len(shape) + len(kind), shape)
    jp, tp = _params(held_out, kind == "layernorm")
    extra = (beta,) if kind == "layernorm" else ()
    jdt = jnp.dtype(dtype)
    jx, jr = jnp.asarray(x).astype(jdt), jnp.asarray(r).astype(jdt)
    tx, tr = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in (x, r))
    jh, jo = jops.residual_norm_fn(kind, "sole", backend="pallas")(
        jx, jr, *(jnp.asarray(a) for a in (gamma,) + extra), params=jp)
    th, to = tops.resolve(f"residual_{kind}", "sole", "cuda")(
        tx, tr, *(torch.from_numpy(a) for a in (gamma,) + extra), params=tp)
    assert th.dtype == torch.float32 and th.shape == shape
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    _close(to.numpy(), jo)


@pytest.mark.parametrize("shape", [(6, 64), (2, 3, 896)])
@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_fused_quant_out_static_params(kind, shape):
    x, r, held_out, gamma, beta = _case(7 + len(shape), shape)
    jp, tp = _params(held_out, kind == "layernorm")
    extra = (beta,) if kind == "layernorm" else ()
    targs = [torch.from_numpy(a) for a in (x, r, gamma) + extra]
    th, (codes, scale) = tops.resolve(f"residual_{kind}_q", "sole", "cuda")(
        *targs, params=tp)
    h, out = tops.resolve(f"residual_{kind}", "sole", "cuda")(*targs,
                                                              params=tp)
    want_codes, want_scale = quantize_act(out)
    assert torch.equal(th, h)
    assert codes.dtype == torch.int8 and scale.shape == shape[:-1] + (1,)
    assert torch.equal(codes, want_codes) and torch.equal(scale, want_scale)
    jh, (jq, js) = jops.residual_norm_q_fn(kind, "sole", backend="pallas")(
        *(jnp.asarray(a) for a in (x, r, gamma) + extra), params=jp)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_allclose(scale.numpy(), np.asarray(js), rtol=3e-7)
    assert (codes.numpy() == np.asarray(jq)).mean() >= 0.99


def test_fused_kernels_without_params_keep_the_calibrating_path():
    """``params=None``: the calibrating path, the add in the inputs' dtype
    and the calibration on ``h`` (on the card one launch of the
    calibrating norm kernel); ``h`` keeps the inputs' dtype and the
    quantize-out twin is ``quantize_act`` of the float32 output."""
    x, r, _, gamma, _ = _case(3, (4, 64))
    tx, tr = (torch.from_numpy(a).bfloat16() for a in (x, r))
    h, out = KN.fused_add_norm(tx, tr, torch.from_numpy(gamma), rms=True)
    assert h.dtype == torch.bfloat16 and torch.equal(h, tx + tr)
    h2, (codes, scale) = KN.fused_add_norm_quant(tx, tr,
                                                 torch.from_numpy(gamma),
                                                 rms=True)
    assert torch.equal(h2, h)
    assert all(torch.equal(a, b) for a, b in zip((codes, scale),
                                                  quantize_act(out)))


@pytest.mark.parametrize("shape", [(7, 64), (2, 3, 200)])
def test_codes_kernel_matches_pallas_and_oracles(shape):
    rng = np.random.default_rng(shape[-1])
    c = shape[-1]
    xi = rng.integers(-128, 128, shape).astype(np.int32)
    alpha = rng.integers(0, 4, c).astype(np.int32)
    gamma = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(c)).astype(np.float32)
    t = [torch.from_numpy(a) for a in (xi, alpha, gamma, beta)]
    j = [jnp.asarray(a) for a in (xi, alpha, gamma, beta)]
    before = KN.codes_norm.launches
    got = KN.ailayernorm_codes(*t)
    assert KN.codes_norm.launches == before          # CPU tensors: plain
    assert got.shape == shape and got.dtype == torch.float32
    _close(got.numpy(), ailayernorm_pallas_codes(*j))
    torch.testing.assert_close(got, tor.ailayernorm_ref(*t), rtol=0,
                               atol=1e-6)
    _close(tor.ailayernorm_ref(*t).numpy(), jor.ailayernorm_ref(*j))


def test_static_params_must_be_ptf_params():
    x = torch.zeros((2, 8))
    with pytest.raises(TypeError, match="PTFQuantParams"):
        tops.resolve("rmsnorm", "sole", "cuda")(x, torch.ones(8),
                                                params=object())


def _kernel_only(name, fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` on meta tensors under a cost counter: it
    reports one launch of kernel ``name``, and no aten op moves a byte or
    multiplies (the plain version did not run)."""
    with CostCounter() as counter:
        out = fn(*args, **kwargs)
    kernels = {k[0]: v[0] for k, v in counter.records.items()
               if k[0].startswith("kernel:")}
    assert kernels == {"kernel:" + name: 1}
    assert not [k for k, v in counter.records.items()
                if not k[0].startswith("kernel:") and (v[1] or v[2])]
    return out


def test_fused_wrappers_take_only_cpu_or_cuda_tensors():
    """No plain version runs off the CPU: on meta tensors (the dry run's
    route) the wrappers return the kernels' outputs and launch nothing."""
    x = torch.zeros((2, 8), device="meta")
    chan = (x[0, :1], x[0].int(), x[0], x[0])
    counts = (KN.add_norm.launches, KN.add_norm_quant.launches,
              KN.codes_norm.launches)
    h, out = _kernel_only("ailayernorm_add_norm", KN.add_norm, x, x, *chan,
                          rms=True)
    assert (h.dtype, out.dtype, out.shape) == (torch.float32, torch.float32,
                                               (2, 8))
    h, codes, scale = _kernel_only("ailayernorm_add_norm_quant",
                                   KN.add_norm_quant, x, x, *chan, rms=True)
    assert (codes.dtype, scale.shape) == (torch.int8, (2, 1))
    xi = x.int()
    out = _kernel_only("ailayernorm_codes", KN.codes_norm, xi, *chan[1:])
    assert out.is_meta and out.shape == (2, 8)
    assert counts == (KN.add_norm.launches, KN.add_norm_quant.launches,
                      KN.codes_norm.launches)
