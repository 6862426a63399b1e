"""The hybrid's recurrent pieces (``repro_torch.models.rglru``) against the
JAX package's ``repro.models.rglru`` on the CPU: float32 4-layer hybrid
smoke config (one rec-rec-attention block and one tail layer), the same
numpy-seeded inputs, the JAX ``init_params`` weights carried through
``params_from_jax``, JAX jitted as the engines run it.

Tolerances, stated per check: the associative scan (the reference's
even/odd recursion, its combine contracted into an FMA as XLA contracts
it) and the causal conv (its taps' FMAs) are bit for bit; the RG-LRU's
gates go through XLA's own ``logistic``/``log1p``/``exp``, which round
apart from torch's by an ulp, so ``rg_lru`` is held to 1e-6; whole blocks
and models add matmuls (1e-5, and 1e-4 of the logits in exact mode).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_config
from repro.models import api as japi
from repro.models import rglru as JG
from repro_torch.configs.base import get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import rglru as TG

EXACT = dict(softmax_mode="exact", norm_mode="exact", logit_int8=False)
HYBRID = dict(n_layers=4, n_tail_layers=1)
LRU_ATOL = 1e-6
BLOCK_ATOL = 1e-5
LOGIT_ATOL = 1e-4
LENGTHS = (1, 2, 3, 5, 8, 16, 17)


def _cfgs(**change):
    change = dict(HYBRID, **change)
    return (dataclasses.replace(jax_config("recurrentgemma_9b").smoke(),
                                **change),
            dataclasses.replace(get_config("recurrentgemma_9b").smoke(),
                                **change))


@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg = _cfgs()
    jp = japi.init_params(0, jcfg)[0]
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")


def _first(tree):
    if isinstance(tree, dict):
        return {k: _first(v) for k, v in tree.items()}
    return tree[0]


def _combine(c1, c2):
    a1, b1 = c1
    a2, b2 = c2
    return a1 * a2, a2 * b1 + b2


@pytest.mark.parametrize("s", LENGTHS)
def test_associative_scan_is_the_references_tree(s):
    rng = np.random.default_rng(s)
    a = rng.uniform(0.2, 1.0, (3, s, 32)).astype(np.float32)
    b = rng.standard_normal((3, s, 32)).astype(np.float32)
    want = jax.jit(lambda a, b: jax.lax.associative_scan(
        _combine, (a, b), axis=1)[1])(a, b)
    got = TG.associative_scan(torch.tensor(a), torch.tensor(b))
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n_valid", [None, (9, 4)])
@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(with_state, n_valid, weights):
    jp, tp = weights
    jr, tr = _first(jp["blocks"]["rec1"]), _first(tp["blocks"]["rec1"])
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 64)).astype(np.float32)
    cs = (rng.standard_normal((2, 3, 64)).astype(np.float32)
          if with_state else None)
    nv = None if n_valid is None else np.array(n_valid, np.int32)
    oj, sj = jax.jit(lambda x, cs, nv: JG._causal_conv(
        x, jr["conv_w"], jr["conv_b"], cs, n_valid=nv))(x, cs, nv)
    ot, st = TG._causal_conv(torch.tensor(x), tr["conv_w"], tr["conv_b"],
                             None if cs is None else torch.tensor(cs),
                             None if nv is None else torch.tensor(nv))
    assert np.array_equal(ot.numpy(), np.asarray(oj))
    assert np.array_equal(st.numpy(), np.asarray(sj))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("s", LENGTHS)
def test_rg_lru_matches_reference(s, with_h0, masked, weights):
    jcfg, tcfg = _cfgs()
    jp, tp = weights
    jr, tr = _first(jp["blocks"]["rec2"]), _first(tp["blocks"]["rec2"])
    rng = np.random.default_rng(10 + s)
    x = rng.standard_normal((2, s, 64)).astype(np.float32)
    h0 = rng.standard_normal((2, 64)).astype(np.float32) if with_h0 else None
    mask = ((np.arange(s)[None] < np.array([s, max(s - 2, 1)])[:, None])
            if masked else None)
    yj, hj = jax.jit(lambda x, h0, m: JG.rg_lru(x, x, jr, jcfg, h0, mask=m))(
        x, h0, mask)
    yt, ht = TG.rg_lru(torch.tensor(x), torch.tensor(x), tr, tcfg,
                       None if h0 is None else torch.tensor(h0),
                       mask=None if mask is None else torch.tensor(mask))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0,
                               atol=LRU_ATOL)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=0,
                               atol=LRU_ATOL)


@pytest.mark.parametrize("mode", ["exact", "sole"])
def test_recurrent_block_matches_reference(mode, weights):
    """The layer with carried state and a padded chunk (``n_valid``)."""
    jcfg, tcfg = _cfgs(**(EXACT if mode == "exact" else {}))
    jp, tp = weights
    jr, tr = _first(jp["tail"]), _first(tp["tail"])
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 6, 64)).astype(np.float32)
    st = {"h": rng.standard_normal((2, 64)).astype(np.float32),
          "conv": rng.standard_normal((2, 3, 64)).astype(np.float32)}
    nv = np.array([6, 3], np.int32)
    xj, sj = jax.jit(lambda x, st, nv: JG.recurrent_block(
        jr, x, jcfg, "serve", st, n_valid=nv))(x, st, nv)
    xt, stt = TG.recurrent_block(tr, torch.tensor(x), tcfg, "serve",
                                 {k: torch.tensor(v) for k, v in st.items()},
                                 n_valid=torch.tensor(nv))
    close = np.abs(xt.numpy() - np.asarray(xj)) <= BLOCK_ATOL
    assert close.mean() >= (1.0 if mode == "exact" else 0.95)
    for k in ("h", "conv"):
        np.testing.assert_allclose(stt[k].numpy(), np.asarray(sj[k]),
                                   rtol=0, atol=BLOCK_ATOL)


@pytest.mark.parametrize("mode", ["exact", "sole"])
def test_forward_matches_reference(mode, weights):
    """Whole-sequence logits (the rec-rec-attention block, the tail):
    exact mode within ``LOGIT_ATOL``, SOLE at least 95% of them."""
    jcfg, tcfg = _cfgs(**(EXACT if mode == "exact" else {}))
    jp, tp = weights
    tokens = np.random.default_rng(3).integers(0, 512, (2, 10)).astype(
        np.int32)
    want = np.asarray(jax.jit(lambda p, t: JG.forward(p, t, jcfg, "serve"))(
        jp, tokens))
    got = TG.forward(tp, torch.tensor(tokens), tcfg, "serve").numpy()
    close = np.abs(got - want) <= LOGIT_ATOL
    assert close.mean() >= (1.0 if mode == "exact" else 0.95)


def test_prefill_and_decode_match_reference(weights):
    """The dense-slot path in exact mode: the prompt's last logits, the
    rolling window cache, then three decode steps through
    ``decode_attend``, against the jitted JAX calls."""
    jcfg, tcfg = _cfgs(**EXACT)
    jp, tp = weights
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, 512, (2, 7)).astype(np.int32)
    lj, cj = jax.jit(lambda p, t: JG.prefill(p, t, jcfg, 12))(jp, tokens)
    lt, ct = TG.prefill(tp, torch.tensor(tokens), tcfg, 12)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0,
                               atol=LOGIT_ATOL)
    assert np.array_equal(ct["blocks"]["attn"]["pos"].numpy(),
                          np.asarray(cj["blocks"]["attn"]["pos"]))
    np.testing.assert_allclose(ct["blocks"]["attn"]["k"].numpy(),
                               np.asarray(cj["blocks"]["attn"]["k"]),
                               rtol=0, atol=BLOCK_ATOL)
    step = jax.jit(lambda p, c, t, pos: JG.decode_step(p, c, t, pos, jcfg))
    for i in range(3):
        tok = rng.integers(0, 512, (2,)).astype(np.int32)
        lj, cj = step(jp, cj, tok, jnp.asarray(7 + i, jnp.int32))
        lt, ct = TG.decode_step(tp, ct, torch.tensor(tok), 7 + i, tcfg)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0,
                                   atol=LOGIT_ATOL)
        assert int(ct["pos"]) == int(cj["pos"]) == 8 + i
