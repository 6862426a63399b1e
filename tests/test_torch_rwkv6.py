"""rwkv6 (``repro_torch.models.rwkv6``) against the JAX package's
``repro.models.rwkv6`` on the CPU, float32 smoke config, the same
numpy-seeded inputs and the JAX ``init_params`` weights carried through
``params_from_jax``. JAX functions run jitted, as the engines run them.

Tolerances, stated per check: the WKV state is the compiled reference's
bit for bit (its two FMAs are taken as FMAs); the WKV outputs sum the
read-out contraction over hd in another order (2e-5 on unit-scale
inputs); whole layers and models add matmuls whose sums round apart and
XLA's own ``exp``/``tanh``/``logistic`` (1e-4 of the logits in exact
mode). The per-head GroupNorm (an (H, hd) affine) is held to the JAX
**reference** backend's ``layernorm`` op: the JAX Pallas entry cannot
take a 2-D affine (``ailayernorm_pallas`` reshapes gamma to (1, C)).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ops as jops
from repro.configs.base import get_config as jax_config
from repro.models import api as japi
from repro.models import rwkv6 as JR
from repro_torch import ops
from repro_torch.configs.base import get_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ailayernorm as KN
from repro_torch.models import rwkv6 as TR

EXACT = dict(softmax_mode="exact", norm_mode="exact", logit_int8=False)
WKV_ATOL = 2e-5
LOGIT_ATOL = 1e-4


def _cfgs(**change):
    return (dataclasses.replace(jax_config("rwkv6_7b").smoke(), **change),
            dataclasses.replace(get_config("rwkv6_7b").smoke(), **change))


@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg = _cfgs()
    jp = japi.init_params(0, jcfg)[0]
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")


def _layer0(tree):
    if isinstance(tree, dict):
        return {k: _layer0(v) for k, v in tree.items()}
    return tree[0]


def _wkv_inputs(rng, b=2, s=12, h=4, d=16):
    r, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32)
               for _ in range(3))
    w = rng.uniform(0.3, 1.0, (b, s, h, d)).astype(np.float32)
    u = rng.standard_normal((h, d)).astype(np.float32)
    s0 = rng.standard_normal((b, h, d, d)).astype(np.float32)
    return r, k, v, w, u, s0


def test_wkv_sequential_matches_reference():
    args = _wkv_inputs(np.random.default_rng(0))
    oj, sj = jax.jit(JR._wkv_sequential)(*args)
    ot, st = TR.wkv_sequential(*map(torch.tensor, args))
    assert np.array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=0,
                               atol=WKV_ATOL)


@pytest.mark.parametrize("chunk", [3, 4])
def test_wkv_chunked_matches_reference_and_sequential(chunk):
    args = _wkv_inputs(np.random.default_rng(1))
    oj, sj = jax.jit(lambda *a: JR._wkv_chunked(*a, chunk))(*args)
    ot, st = TR.wkv_chunked(*map(torch.tensor, args), chunk)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=0,
                               atol=WKV_ATOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=0,
                               atol=WKV_ATOL)
    os_, ss = TR.wkv_sequential(*map(torch.tensor, args))
    np.testing.assert_allclose(ot.numpy(), os_.numpy(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(st.numpy(), ss.numpy(), rtol=0, atol=1e-4)


@pytest.mark.parametrize("mode", ["exact", "sole"])
def test_time_and_channel_mix_match_reference(mode, weights):
    jcfg, tcfg = _cfgs(**(EXACT if mode == "exact" else {}))
    jp, tp = weights
    jl, tl = _layer0(jp["layers"]), _layer0(tp["layers"])
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, tcfg.d_model)).astype(np.float32)
    last = rng.standard_normal((2, tcfg.d_model)).astype(np.float32)
    s0 = rng.standard_normal((2, 4, 16, 16)).astype(np.float32) * 0.1
    oj, xj, sj = jax.jit(lambda *a: JR.time_mix(jl["tm"], *a, jcfg,
                                                "serve"))(x, last, s0)
    ot, xt, st = TR.time_mix(tl["tm"], torch.tensor(x), torch.tensor(last),
                             torch.tensor(s0), tcfg, "serve")
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=0,
                               atol=WKV_ATOL)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=0,
                               atol=LOGIT_ATOL)
    assert np.array_equal(xt.numpy(), np.asarray(xj))
    cj, _ = jax.jit(lambda *a: JR.channel_mix(jl["cm"], *a, jcfg))(x, last)
    ct, _ = TR.channel_mix(tl["cm"], torch.tensor(x), torch.tensor(last),
                           tcfg)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=0,
                               atol=LOGIT_ATOL)


def test_masked_steps_are_the_identity(weights):
    """A padded chunk with ``mask``: the carried state equals the state
    after the real tokens alone, bit for bit (w := 1, k := 0 past the
    tail), on both sides."""
    jcfg, tcfg = _cfgs(**EXACT)
    jp, tp = weights
    jl, tl = _layer0(jp["layers"]), _layer0(tp["layers"])
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 8, tcfg.d_model)).astype(np.float32)
    last = np.zeros((2, tcfg.d_model), np.float32)
    s0 = np.zeros((2, 4, 16, 16), np.float32)
    n_valid = np.array([5, 8])
    mask = np.arange(8)[None] < n_valid[:, None]
    _, _, st = TR.time_mix(tl["tm"], torch.tensor(x), torch.tensor(last),
                           torch.tensor(s0), tcfg, "serve",
                           mask=torch.tensor(mask))
    _, _, alone = TR.time_mix(tl["tm"], torch.tensor(x[:1, :5]),
                              torch.tensor(last[:1]), torch.tensor(s0[:1]),
                              tcfg, "serve")
    assert torch.equal(st[0], alone[0])
    _, _, sj = jax.jit(lambda *a: JR.time_mix(jl["tm"], *a, jcfg, "serve",
                                              mask=mask))(x, last, s0)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=0,
                               atol=WKV_ATOL)


def _groupnorm_inputs(rng, rows=(2, 5), h=4, d=16):
    o = rng.standard_normal(rows + (h, d)).astype(np.float32) * 3
    o[..., ::5] *= 6                                # outlier channels
    g = (1 + 0.1 * rng.standard_normal((h, d))).astype(np.float32)
    b = (0.1 * rng.standard_normal((h, d))).astype(np.float32)
    return o, g, b


@pytest.mark.parametrize("backend", ["reference", "cuda"])
@pytest.mark.parametrize("mode", ["exact", "sole"])
def test_group_norm_matches_reference_backend(mode, backend):
    """The ``layernorm`` op on (B, S, H, hd) with (H, hd) params, on CPU
    tensors through each port backend (``cuda`` on CPU tensors is the
    kernels' plain versions, the (G, C) affine), against the JAX
    reference backend's op, jitted: exact mode within 1e-6, SOLE within
    1e-5 of the output scale (the codes are equal; XLA's ``rsqrt`` and
    the reference's division forms part the affine in the last bits)."""
    o, g, b = _groupnorm_inputs(np.random.default_rng(4))
    want = np.asarray(jax.jit(lambda *a: jops.resolve(
        "layernorm", mode, "reference")(*a))(o, g, b))
    got = ops.resolve("layernorm", mode, backend)(
        torch.tensor(o), torch.tensor(g), torch.tensor(b)).numpy()
    tol = (1e-6 if mode == "exact" else 1e-5) * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


@pytest.mark.parametrize("mode", ["exact", "sole"])
def test_group_norm_affine_rows_are_per_head(mode):
    """The (G, C) affine: row r of the flattened rows takes gamma/beta row
    r mod G; each head's rows equal a (C,) call with that head's params
    and the same calibration (SOLE), or alone (exact), bit for bit."""
    o, g, b = map(torch.tensor, _groupnorm_inputs(np.random.default_rng(5)))
    rows = o.reshape(-1, 16)
    if mode == "exact":
        full = KN.exact_norm_plain(rows, g, b, rms=False, eps=1e-5)
        for hh in range(4):
            one = KN.exact_norm_plain(rows[hh::4], g[hh], b[hh], rms=False,
                                      eps=1e-5)
            assert torch.equal(full[hh::4], one)
        return
    _, full, alpha, scale = KN.calibrated_norm_plain(rows, None, g, b,
                                                     rms=False)
    for hh in range(4):
        one = KN.qnorm_plain(rows[hh::4], scale, alpha, g[hh], b[hh],
                             rms=False)
        assert torch.equal(full[hh::4], one)
    with pytest.raises(ValueError, match="multiple of 4"):
        KN.calibrated_norm_plain(rows[:5], None, g, b, rms=False)


@pytest.mark.parametrize("mode", ["exact", "sole"])
def test_forward_matches_reference(mode, weights):
    """Whole-sequence logits: exact mode within ``LOGIT_ATOL``; SOLE mode
    at least 95% of the logits within it (a norm code can flip on a
    one-ulp difference)."""
    jcfg, tcfg = _cfgs(**(EXACT if mode == "exact" else {}))
    jp, tp = weights
    tokens = np.random.default_rng(6).integers(0, 512, (2, 11)).astype(
        np.int32)
    want = np.asarray(jax.jit(lambda p, t: JR.forward(p, t, jcfg, "serve"))(
        jp, tokens))
    got = TR.forward(tp, torch.tensor(tokens), tcfg, "serve").numpy()
    close = np.abs(got - want) <= LOGIT_ATOL
    assert close.mean() >= (1.0 if mode == "exact" else 0.95)


def test_prefill_and_decode_match_reference(weights):
    """The dense-slot path in exact mode: the prompt's last logits and
    stacked state, then three decode steps on the state, against the
    jitted JAX ``prefill``/``decode_step``."""
    jcfg, tcfg = _cfgs(**EXACT)
    jp, tp = weights
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, 512, (2, 9)).astype(np.int32)
    lj, cj = jax.jit(lambda p, t: JR.prefill(p, t, jcfg, 16))(jp, tokens)
    lt, ct = TR.prefill(tp, torch.tensor(tokens), tcfg, 16)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0,
                               atol=LOGIT_ATOL)
    for k in ("tm_x", "cm_x", "s"):
        np.testing.assert_allclose(ct[k].numpy(), np.asarray(cj[k]), rtol=0,
                                   atol=LOGIT_ATOL)
    step = jax.jit(lambda p, c, t, pos: JR.decode_step(p, c, t, pos, jcfg))
    for i in range(3):
        tok = rng.integers(0, 512, (2,)).astype(np.int32)
        lj, cj = step(jp, cj, tok, jnp.asarray(9 + i, jnp.int32))
        lt, ct = TR.decode_step(tp, ct, torch.tensor(tok), 9 + i, tcfg)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0,
                                   atol=LOGIT_ATOL)
        assert int(lt.argmax(-1)[0]) == int(np.asarray(lj).argmax(-1)[0])


def test_paged_chunks_equal_the_whole_prompt(weights):
    """Chunked paged prefill over slot state computes what the whole
    prompt computes (a strict left-to-right scan): three ragged chunks
    through ``prefill_paged`` leave the slot with the dense path's state
    (exact mode, 1e-5)."""
    _, tcfg = _cfgs(**EXACT)
    _, tp = weights
    from repro_torch.models import api
    spec = api.sequence_state_spec(tcfg)
    from repro_torch.serve.state import StateSlotPool
    pool = StateSlotPool(spec, num_slots=3, device="cpu")
    tokens = np.random.default_rng(8).integers(0, 512, 11).astype(np.int32)
    refs = {"slots": torch.tensor([2], dtype=torch.int32)}
    state = {"slots": pool.slots}
    start = 0
    for n in (4, 4, 3):
        chunk = np.zeros((1, 4), np.int32)
        chunk[0, :n] = tokens[start:start + n]
        _, state = TR.prefill_paged(tp, torch.tensor(chunk),
                                    torch.tensor([start]), torch.tensor([n]),
                                    refs, state, tcfg)
        start += n
    _, cache = TR.prefill(tp, torch.tensor(tokens[None]), tcfg)
    for k in ("tm_x", "cm_x", "s"):
        np.testing.assert_allclose(state["slots"][k][2].numpy(),
                                   cache[k][:, 0].numpy(), rtol=0, atol=1e-5)
