"""Gradients of the port's exact-mode norms on the CPU against
``jax.grad`` of the JAX package's reference ops (``repro.ops.reference``
``exact_layernorm``/``exact_rmsnorm`` and their residual forms, and
rwkv6's per-head ``_group_norm`` on JAX's reference backend), with the
same numpy-seeded inputs and cotangents.

On the CPU the port's exact norms are plain torch ops (the exact norm
kernel's plain version), so these are autograd's gradients; on the card
the same calls run ``exact_norm_bwd_kernel`` (``tests/test_torch_cuda.py``
holds it to this plain route). Tolerances: float32 gradients within 1e-5
of their leaf's largest magnitude (the two frameworks reduce each row in
other orders, and XLA's ``rsqrt`` is not torch's); bf16 input gradients,
which both sides round from float32, within one bf16 ulp of the larger.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ops as jops
from repro.configs.base import get_config as jax_config
from repro.models import rwkv6 as JR
from repro_torch import ops as tops
from repro_torch.configs.base import get_config
from repro_torch.kernels import ailayernorm as KN
from repro_torch.kernels import build
from repro_torch.models import layers as TL
from repro_torch.models import rwkv6 as TR
from tests._torch_train_cases import one_torch_thread  # noqa: F401

RTOL = 1e-5
CASES = (("layernorm", 64), ("layernorm", 768), ("rmsnorm", 64),
         ("rmsnorm", 896))


def _inputs(seed, shape, c, groups=None):
    rng = np.random.default_rng(seed)
    lead = (groups, c) if groups else (c,)
    x = (rng.standard_normal(shape) * 2 + rng.standard_normal(
        shape[:-1] + (1,))).astype(np.float32)
    return dict(x=x, r=rng.standard_normal(shape).astype(np.float32),
                g=(1 + 0.1 * rng.standard_normal(lead)).astype(np.float32),
                b=(0.1 * rng.standard_normal(lead)).astype(np.float32),
                w=rng.standard_normal(shape).astype(np.float32),
                w2=rng.standard_normal(shape).astype(np.float32))


def _close(got, want, what):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= RTOL * scale, f"{what}: {err} > {RTOL} x {scale}"


def _torch_grads(fn, arrays, names, dtype=torch.float32):
    ts = {k: torch.tensor(v).to(dtype if k == "x" else torch.float32)
          .requires_grad_(k in names) for k, v in arrays.items()}
    out = fn(ts)
    outs = out if isinstance(out, tuple) else (out,)
    loss = sum((o.float() * ts[w]).sum() for o, w in zip(outs, ("w", "w2")))
    grads = torch.autograd.grad(loss, [ts[k] for k in names])
    return dict(zip(names, grads))


def _jax_grads(fn, arrays, names, dtype=jnp.float32):
    def loss(*vals):
        a = dict(arrays, **dict(zip(names, vals)))
        out = fn(a)
        outs = out if isinstance(out, tuple) else (out,)
        return sum(jnp.sum(o.astype(jnp.float32) * a[w])
                   for o, w in zip(outs, ("w", "w2")))
    vals = [jnp.asarray(arrays[k]).astype(dtype if k == "x" else jnp.float32)
            for k in names]
    grads = jax.grad(loss, argnums=tuple(range(len(names))))(*vals)
    return dict(zip(names, grads))


@pytest.mark.parametrize("kind,c", CASES)
def test_exact_norm_grads_match_jax(kind, c):
    a = _inputs(1, (3, 5, c), c)
    rms = kind == "rmsnorm"
    names = ("x", "g") if rms else ("x", "g", "b")
    if rms:
        tf = lambda t: tops.rmsnorm_fn("exact", "cpu")(t["x"], t["g"])  # noqa
        jf = lambda t: jops.resolve("rmsnorm", "exact", "reference")(  # noqa
            t["x"], t["g"])
    else:
        tf = lambda t: tops.layernorm_fn("exact", "cpu")(  # noqa
            t["x"], t["g"], t["b"])
        jf = lambda t: jops.resolve("layernorm", "exact", "reference")(  # noqa
            t["x"], t["g"], t["b"])
    tg, jg = _torch_grads(tf, a, names), _jax_grads(jf, a, names)
    for k in names:
        _close(tg[k], jg[k], f"{kind} {c} d{k}")


@pytest.mark.parametrize("kind,c", CASES)
def test_residual_norm_grads_match_jax(kind, c):
    """``residual_*`` exact: (x + r, norm(x + r)), cotangents on both."""
    a = _inputs(2, (4, 3, c), c)
    rms = kind == "rmsnorm"
    names = ("x", "r", "g") if rms else ("x", "r", "g", "b")
    tfn = tops.residual_norm_fn(kind, "exact", "cpu")
    jfn = jops.resolve(f"residual_{kind}", "exact", "reference")
    extra = (lambda t: ()) if rms else (lambda t: (t["b"],))
    tg = _torch_grads(lambda t: tfn(t["x"], t["r"], t["g"], *extra(t)), a,
                      names)
    jg = _jax_grads(lambda t: jfn(t["x"], t["r"], t["g"], *extra(t)), a,
                    names)
    for k in names:
        _close(tg[k], jg[k], f"residual {kind} {c} d{k}")


def test_groupnorm_grads_match_rwkv6_reference_backend():
    """rwkv6's per-head GroupNorm at its full head layout, (64, 64): o
    (B, S, 64 heads, 64) with a (64, 64) affine, the port's ``_group_norm``
    against the JAX one on its reference backend."""
    jc = dataclasses.replace(jax_config("rwkv6_7b"), ops_backend="reference")
    tc = get_config("rwkv6_7b")
    a = _inputs(3, (2, 3, 64, 64), 64, groups=64)
    names = ("x", "g", "b")
    tg = _torch_grads(lambda t: TR._group_norm(t["x"], t["g"], t["b"], tc,
                                               "train"), a, names)
    jg = _jax_grads(lambda t: JR._group_norm(t["x"], t["g"], t["b"], jc,
                                             "train"), a, names)
    for k in names:
        _close(tg[k], jg[k], f"groupnorm d{k}")


@pytest.mark.parametrize("kind", ("layernorm", "rmsnorm"))
def test_bf16_input_grads_match_jax(kind):
    """bf16 rows: both sides normalize in float32 and round dx to bf16."""
    c = 896
    a = _inputs(4, (6, c), c)
    rms = kind == "rmsnorm"
    names = ("x", "g") if rms else ("x", "g", "b")
    extra = (lambda t: ()) if rms else (lambda t: (t["b"],))
    tfn = (tops.rmsnorm_fn if rms else tops.layernorm_fn)("exact", "cpu")
    jfn = jops.resolve(kind, "exact", "reference")
    tg = _torch_grads(lambda t: tfn(t["x"], t["g"], *extra(t)), a, names,
                      torch.bfloat16)
    jg = _jax_grads(lambda t: jfn(t["x"], t["g"], *extra(t)), a, names,
                    jnp.bfloat16)
    assert tg["x"].dtype == torch.bfloat16
    got = tg["x"].float().numpy()
    want = np.asarray(jg["x"].astype(jnp.float32))
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126)))
                  - 7)
    assert (np.abs(got - want) <= ulp).all()
    for k in names[1:]:
        _close(tg[k], jg[k], f"bf16 {kind} d{k}")


@pytest.mark.parametrize("rms", (True, False))
@pytest.mark.parametrize("groups", (1, 4))
def test_exact_norm_backward_cpu_route(rms, groups):
    """``exact_norm_backward`` on CPU tensors (the backward kernel's plain
    version) is autograd through ``exact_norm`` itself, bit for bit:
    (rows, C) x with a (C,) or (G, C) affine, float32 and bf16 rows."""
    c = 96
    a = _inputs(5, (8, c), c, groups=groups if groups > 1 else None)
    g = torch.tensor(a["g"])
    b = None if rms else torch.tensor(a["b"])
    for dt in (torch.float32, torch.bfloat16):
        x = torch.tensor(a["x"]).to(dt)
        dy = torch.tensor(a["w"]).to(dt)
        dx, dg, db = KN.exact_norm_backward(x, g, b, dy, rms=rms, eps=1e-5)
        xs, gs = x.clone().requires_grad_(True), g.clone().requires_grad_(True)
        bs = None if rms else b.clone().requires_grad_(True)
        out = KN.exact_norm(xs, gs, bs, rms=rms, eps=1e-5)
        want = torch.autograd.grad(out, [t for t in (xs, gs, bs)
                                         if t is not None], dy.float())
        assert dx.dtype == dt and torch.equal(dx, want[0])
        assert torch.equal(dg, want[1])
        assert db is None if rms else torch.equal(db, want[2])


def test_backward_chunks_are_fixed_by_the_shape():
    """The backward kernel's plan: rows per CTA and CTAs from (rows, C, G)
    alone (the same on every call, whatever card runs it), chunks a
    multiple of G covering the rows in at most ``BWD_CTAS`` CTAs; the
    train shape (8,192 rows of 896) gets 256 CTAs, about two for each of
    an H100's 132 SMs, each team 8 rows, and 8 rows one row for each
    team."""
    assert KN.exact_team(896) == 32 and KN.exact_team(64) == 2
    assert KN.exact_team(6144) == 256 and KN.exact_team(16) == 1
    chunk, ctas = KN.bwd_plan(8192, 896, 1)
    assert chunk % (KN.EXACT_CTA // 32) == 0
    assert (chunk, ctas) == (32, 256)
    for c in (768, 896, 2048, 3584, 4096, 6144):
        chunk, ctas = KN.bwd_plan(8, c, 1)
        teams = KN.EXACT_CTA // KN.exact_team(c) if KN.exact_team(c) <= 32 \
            else 1
        assert chunk == teams and ctas == -(-8 // teams)
    assert KN.bwd_plan(512, 64, 64) == (64, 8)
    for rows, c, g in ((8192, 896, 1), (512, 64, 64), (153600, 64, 64),
                       (2400, 6144, 1), (2100, 100, 7), (3000, 3000, 3),
                       (1000, 10, 1000), (30, 64, 3), (40, 896, 1)):
        chunk, ctas = KN.bwd_plan(rows, c, g)
        assert chunk % g == 0 and chunk >= 1 and ctas <= KN.BWD_CTAS
        assert (ctas - 1) * chunk < rows <= ctas * chunk
        assert KN.bwd_plan(rows, c, g) == (chunk, ctas)


def test_refuse_grad_only_where_autograd_records():
    """The kernels without a backward refuse inputs that require grad
    while grad mode is on (on CUDA tensors; ``build.refuse_grad``), and
    accept them under ``no_grad`` or detached."""
    x = torch.ones(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward kernel"):
        build.refuse_grad("e2softmax", x, None)
    with torch.no_grad():
        build.refuse_grad("e2softmax", x)
    build.refuse_grad("e2softmax", x.detach(), None)


def test_fma_gradient_is_a_times_b_plus_c():
    """``layers.fma`` (the single-rounding FMA of the recurrent families)
    carries the gradient of ``a * b + c``, broadcasting included."""
    rng = np.random.default_rng(6)
    a = torch.tensor(rng.standard_normal((4, 5)), dtype=torch.float32,
                     requires_grad=True)
    b = torch.tensor(rng.standard_normal((5,)), dtype=torch.float32,
                     requires_grad=True)
    c = torch.tensor(rng.standard_normal((4, 1)), dtype=torch.float32,
                     requires_grad=True)
    w = torch.tensor(rng.standard_normal((4, 5)), dtype=torch.float32)
    out = TL.fma(a, b, c)
    assert torch.equal(out, KN.fma32(a, b, c).to(torch.float32))
    got = torch.autograd.grad((out * w).sum(), [a, b, c])
    want = torch.autograd.grad(((a * b + c) * w).sum(), [a, b, c])
    for g, e in zip(got, want):
        assert g.shape == e.shape and torch.allclose(g, e, rtol=0, atol=0)
