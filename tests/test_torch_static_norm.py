"""The static-params SOLE norms (``layernorm``/``rmsnorm``, their residual
and quantize-out twins, with ``params=`` a ``PTFQuantParams``) on float32
and bf16 activations, against the JAX package's Pallas kernels on the CPU
(``_qnorm_call``, ``_fused_call``, ``_fused_q_call`` in interpret mode,
through ``repro.ops.*_fn(..., backend="pallas")``), and the port's own
routes: the kernels form ``denom = scale * 2^alpha`` themselves (one
multiply by the exact power of two), read bf16 rows as they are and write
a bf16 output.

The port's ``cuda`` adapters hand CPU tensors to the kernel wrappers,
which compute the kernels' plain versions on the rows read as float32,
as the reference's ``astype(float32)`` does. The params are calibrated
once on a held-out batch of the activations' dtype (a bf16 scale for bf16
rows) and handed to both sides.

Tolerances, and why:
* ``h = x + r``: one float32 add of the float32 rows on both sides:
  bitwise.
* norm outputs: codes and int32 sums are exact on both sides; the float
  epilogue differs only by XLA's approximate CPU ``rsqrt``: 1e-6 of the
  output scale.
* quantize-out: the scale to 3e-7 relative and at least 99% of the codes
  equal (an output one ulp apart can move a code at a tie).
* ``ldexp(scale, alpha)``, the kernels' multiply and
  ``PTFQuantParams.denom()``: all exact powers of two times the float32
  scale: bitwise.
* the bf16 output and the old CPU route: the same float32 arithmetic,
  then one rounding: bitwise.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ops as jops
from repro.core.sole.quant import calibrate_ptf as j_calibrate_ptf
from repro_torch import ops as tops
from repro_torch.core.sole.quant import PTFQuantParams, calibrate_ptf
from repro_torch.kernels import ailayernorm as KN

DTYPES = ["float32", "bfloat16"]
KINDS = ["rmsnorm", "layernorm"]
SHAPES = [(6, 64), (2, 3, 896)]


def _case(seed, shape, dtype):
    """x, r, a held-out batch in ``dtype`` (numpy float32 values already
    rounded to it, so both sides read the same numbers), gamma, beta."""
    rng = np.random.default_rng(seed)
    c = shape[-1]

    def acts():
        x = rng.standard_normal(shape).astype(np.float32) * 2
        return x * (2.0 ** rng.integers(0, 4, size=c)).astype(np.float32)

    def rounded(a):
        return torch.from_numpy(a).to(getattr(torch, dtype)).float().numpy()

    x, r, held_out = (rounded(a) for a in (acts(), rng.standard_normal(
        shape).astype(np.float32), acts()))
    gamma = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(c)).astype(np.float32)
    return x, r, held_out, gamma, beta


def _params(held_out, dtype, unsigned):
    jp = j_calibrate_ptf(jnp.asarray(held_out).astype(jnp.dtype(dtype)),
                         unsigned=unsigned)
    tp = calibrate_ptf(torch.from_numpy(held_out).to(getattr(torch, dtype)),
                       unsigned=unsigned)
    assert str(tp.scale.dtype) == f"torch.{dtype}"
    assert float(jp.scale) == tp.scale.item()
    np.testing.assert_array_equal(np.asarray(jp.alpha), tp.alpha.numpy())
    return jp, tp


def _close(got, want, rel=1e-6):
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=rel * scale)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("entry", ["norm", "residual", "residual_q"])
def test_static_ops_match_pallas(entry, kind, dtype, shape):
    """Each static-params op on float32 or bf16 rows against the Pallas
    call it ports: ``h`` exact, the norm to 1e-6, the quantize-out codes
    to a 99% share and their scale to 3e-7."""
    x, r, held_out, gamma, beta = _case(len(entry) * 7 + len(shape), shape,
                                        dtype)
    jp, tp = _params(held_out, dtype, kind == "layernorm")
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    extra = (beta,) if kind == "layernorm" else ()
    jx, jr = (jnp.asarray(a).astype(jdt) for a in (x, r))
    tx, tr = (torch.from_numpy(a).to(tdt) for a in (x, r))
    jc = [jnp.asarray(a) for a in (gamma,) + extra]
    tc = [torch.from_numpy(a) for a in (gamma,) + extra]
    if entry == "norm":
        want = getattr(jops, f"{kind}_fn")("sole", backend="pallas")(
            jx, *jc, params=jp)
        got = tops.resolve(kind, "sole", "cuda")(tx, *tc, params=tp)
        assert got.dtype == torch.float32 and got.shape == shape
        _close(got.numpy(), want)
    elif entry == "residual":
        jh, jo = jops.residual_norm_fn(kind, "sole", backend="pallas")(
            jx, jr, *jc, params=jp)
        th, to = tops.resolve(f"residual_{kind}", "sole", "cuda")(
            tx, tr, *tc, params=tp)
        assert th.dtype == torch.float32 and th.shape == shape
        np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
        _close(to.numpy(), jo)
    else:
        jh, (jq, js) = jops.residual_norm_q_fn(kind, "sole",
                                               backend="pallas")(
            jx, jr, *jc, params=jp)
        th, (codes, scale) = tops.resolve(f"residual_{kind}_q", "sole",
                                          "cuda")(tx, tr, *tc, params=tp)
        assert codes.dtype == torch.int8 and scale.shape == shape[:-1] + (1,)
        np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
        np.testing.assert_allclose(scale.numpy(), np.asarray(js), rtol=3e-7)
        assert (codes.numpy() == np.asarray(jq)).mean() >= 0.99


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("source", ["calibrated", "sweep"])
def test_ldexp_equals_ptf_denom(source, dtype):
    """Three forms of ``denom_c = scale * 2^alpha_c`` agree bit for bit,
    for every alpha 0-3: numpy's ``ldexp``, the kernels' formula (a float32
    multiply by the power of two built from its exponent bits, done here
    in numpy) and ``PTFQuantParams.denom()`` (``scale.float() *
    exp2(alpha)``); on scales calibrated in the dtype, and on a sweep of
    scales over 80 binades rounded to it plus scales no calibration gives
    (2^100, subnormal). The kernels themselves are held to the plain
    versions on the card (``test_static_norm_extreme_scales`` and the
    entries' bitwise tests in ``tests/test_torch_cuda.py``)."""
    tdt = getattr(torch, dtype)
    if source == "calibrated":
        scales = []
        for seed in range(8):
            x, _, _, _, _ = _case(seed, (16, 896), dtype)
            for unsigned in (True, False):
                scales.append(calibrate_ptf(torch.from_numpy(x).to(tdt),
                                            unsigned=unsigned).scale)
    else:
        rng = np.random.default_rng(18)
        vals = (rng.uniform(1, 2, 400)
                * 2.0 ** rng.integers(-40, 40, 400)).astype(np.float32)
        vals = np.concatenate([vals, np.float32([2.0 ** 100, 2.0 ** -130,
                                                 2.0 ** -133])])
        scales = list(torch.from_numpy(vals).to(tdt))
    alpha = torch.arange(4, dtype=torch.int32)
    pow2 = ((127 + alpha.numpy()) << 23).astype(np.int32).view(np.float32)
    for s in scales:
        denom = PTFQuantParams(scale=s, zero_point=0, alpha=alpha,
                               unsigned=False).denom()
        sf = np.float32(s.float().item())
        want = np.ldexp(sf, alpha.numpy())
        kernel = sf * pow2
        assert want.dtype == kernel.dtype == np.float32
        np.testing.assert_array_equal(kernel.view(np.int32),
                                      want.view(np.int32))
        np.testing.assert_array_equal(denom.numpy().view(np.int32),
                                      want.view(np.int32))


@pytest.mark.parametrize("rms", [True, False], ids=["rms", "ln"])
@pytest.mark.parametrize("entry", ["qnorm", "add_norm", "add_norm_quant"])
def test_cpu_wrappers_bf16_rows_and_out(entry, rms):
    """The wrappers on CPU tensors: bf16 rows with ``out_dtype=bfloat16``
    equal the float32 route (the rows as float32, float32 out) followed by
    ``.to(bfloat16)``; ``h`` and the codes equal the float32 route's."""
    x, r, held_out, gamma, beta = _case(31 + rms, (9, 200), "bfloat16")
    xb, rb = (torch.from_numpy(a).bfloat16() for a in (x, r))
    p = calibrate_ptf(torch.from_numpy(held_out).bfloat16(), unsigned=not rms)
    chan = (p.scale, p.alpha, torch.from_numpy(gamma),
            None if rms else torch.from_numpy(beta))
    before = (KN.qnorm.launches, KN.add_norm.launches,
              KN.add_norm_quant.launches)
    if entry == "qnorm":
        got = KN.qnorm(xb, *chan, rms=rms, out_dtype=torch.bfloat16)
        want = KN.qnorm(xb.float(), *chan, rms=rms)
        assert want.dtype == torch.float32
        assert got.dtype == torch.bfloat16
        assert torch.equal(got, want.to(torch.bfloat16))
    elif entry == "add_norm":
        h, got = KN.add_norm(xb, rb, *chan, rms=rms, out_dtype=torch.bfloat16)
        h32, want = KN.add_norm(xb.float(), rb.float(), *chan, rms=rms)
        assert h.dtype == torch.float32 and torch.equal(h, h32)
        assert got.dtype == torch.bfloat16
        assert torch.equal(got, want.to(torch.bfloat16))
    else:
        got = KN.add_norm_quant(xb, rb, *chan, rms=rms)
        want = KN.add_norm_quant(xb.float(), rb.float(), *chan, rms=rms)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (KN.qnorm.launches, KN.add_norm.launches,
            KN.add_norm_quant.launches) == before   # CPU tensors: plain


def _old_route(op, kind, x, r, gamma, beta, p, out_dtype):
    """The static-params op on the CPU as the port computed it before its
    kernels read bf16 rows and the PTF scale: rows cast to float32,
    ``p.denom()``, a zero beta for RMS, the norm in float32, the output
    cast to ``out_dtype``."""
    rms = kind == "rmsnorm"
    b = torch.zeros_like(gamma) if (rms or beta is None) else beta
    h = x.float() if op == "norm" else x.float() + r.float()
    xi = KN.ptf_codes(h, p.denom())
    out = KN._norm_codes_plain(xi, p.alpha, gamma.float(), b.float(),
                               rms=rms)
    return h, out.to(out_dtype or torch.float32)


@pytest.mark.parametrize("out_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("op", ["norm", "residual"])
def test_cpu_results_unchanged(op, kind, dtype, out_dtype):
    """On CPU tensors the static-params ops give, bit for bit, what the
    port's route of cast rows, ``denom()`` and a zero beta gave."""
    x, r, held_out, gamma, beta = _case(5 + len(kind), (2, 3, 96), dtype)
    tdt = getattr(torch, dtype)
    od = None if out_dtype is None else getattr(torch, out_dtype)
    tx, tr = (torch.from_numpy(a).to(tdt) for a in (x, r))
    tg, tb = torch.from_numpy(gamma), torch.from_numpy(beta)
    p = calibrate_ptf(torch.from_numpy(held_out).to(tdt),
                      unsigned=kind == "layernorm")
    extra = (tb,) if kind == "layernorm" else ()
    h_old, out_old = _old_route(op, kind, tx, tr, tg, tb, p, od)
    if op == "norm":
        got = tops.resolve(kind, "sole", "cuda")(tx, tg, *extra, params=p,
                                                 out_dtype=od)
    else:
        h, got = tops.resolve(f"residual_{kind}", "sole", "cuda")(
            tx, tr, tg, *extra, params=p, out_dtype=od)
        assert torch.equal(h, h_old)
    assert got.dtype == out_old.dtype and torch.equal(got, out_old)
