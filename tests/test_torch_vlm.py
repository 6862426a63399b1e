"""qwen2-vl (``repro_torch.models.vlm`` and the M-RoPE layers) against the
JAX package's ``repro.models.vlm`` on the CPU: the float32 smoke config
(2 layers, d 64, 4 heads on 2 KV heads, head dim 16), the JAX
``init_params`` weights through ``params_from_jax`` and the same
numpy-seeded inputs; JAX functions run jitted.

Inputs are a multimodal prompt: a 4 x 4 patch grid (temporal 0, height
and width the patch's row and column) at flat positions 0-15, then text
whose three position ids are its flat position, as the decode step's are.

Tolerances, stated per check: ``apply_mrope`` to 2e-6 of unit rows at the
prompt's positions (XLA's and torch's float32 ``cos``/``sin`` and the
``pow`` behind the frequencies round an ulp apart), and to ``|x| * pos *
2**-24`` at positions up to 3,000; logits to 1e-4 in exact and SOLE mode
(the smoke head dim 16 makes ``d^-1/2`` a power of two, so SOLE's int8
snap sees equal inputs; at qwen2_vl_7b's head dim 128 it does not, which
the card's checks hold to a share of rows).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_config
from repro.models import api as japi
from repro.models import layers as JL
from repro.models import vlm as JV
from repro.serve.engine import Engine as JaxDense
from repro.serve.engine import PagedEngine as JaxPaged
from repro_torch.configs.base import get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import api
from repro_torch.models import layers as TL
from repro_torch.serve.engine import Engine, PagedEngine

EXACT = dict(softmax_mode="exact", norm_mode="exact", logit_int8=False)
ROPE_ATOL = 2e-6
LOGIT_ATOL = 1e-4
MODES = ("exact", "sole")
GRID = 4                                  # the prompt's patch grid side


def _cfgs(mode="exact", **change):
    kw = dict(EXACT if mode == "exact" else {}, **change)
    return (dataclasses.replace(jax_config("qwen2_vl_7b").smoke(), **kw),
            dataclasses.replace(get_config("qwen2_vl_7b").smoke(), **kw))


@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg = _cfgs()
    jp = japi.init_params(0, jcfg)[0]
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")


def positions3(b, s):
    """(3, b, s) ids: the patch grid at flat 0..GRID^2-1 (t 0, h row, w
    column), then text at its flat position on all three axes."""
    pos = np.broadcast_to(np.arange(s), (3, b, s)).astype(np.int32).copy()
    n = GRID * GRID
    pos[0, :, :n] = 0
    pos[1, :, :n] = np.arange(n) // GRID
    pos[2, :, :n] = np.arange(n) % GRID
    return pos


def _prompt(jp, rng, b, s):
    """Token ids and their embeddings (the patch rows perturbed so they
    are not token rows), with the prompt's position ids."""
    toks = rng.integers(0, 512, (b, s)).astype(np.int32)
    emb = np.asarray(jp["embed"]["table"])[toks].copy()
    emb[:, :GRID * GRID] += (rng.standard_normal((b, GRID * GRID, 64))
                             * 0.02).astype(np.float32)
    return toks, emb, positions3(b, s)


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=0,
                               atol=atol)


@pytest.mark.parametrize("head_dim", [16, 64, 128, 80])
def test_mrope_sections_match_reference(head_dim):
    jcfg, tcfg = _cfgs(head_dim=head_dim)
    secs = TL.mrope_sections(tcfg)
    assert secs == JL.mrope_sections(jcfg)
    assert sum(secs) == head_dim // 2


@pytest.mark.parametrize("head_dim", [16, 128])
def test_apply_mrope_matches_reference(head_dim):
    """Distinct (t, h, w) ids per token (each section turns with its own
    axis) on (2, 24, 4, head_dim) rows; the three axes equal give RoPE."""
    jcfg, tcfg = _cfgs(head_dim=head_dim, rope_theta=1e6)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 24, 4, head_dim)).astype(np.float32)
    pos = rng.integers(0, 3000, (3, 2, 24)).astype(np.int32)
    want = jax.jit(lambda x, p: JL.apply_mrope(x, p, jcfg))(jnp.asarray(x),
                                                            jnp.asarray(pos))
    got = TL.apply_mrope(torch.tensor(x), torch.tensor(pos), tcfg)
    # the angle carries an ulp of the frequency (2^-24 relative) times
    # the position, and moves the rotated pair by at most |x| times that
    _close(got, want, np.abs(x).max() * pos.max() * 2.0 ** -24)
    same = np.broadcast_to(pos[0], (3, 2, 24))
    a = TL.apply_mrope(torch.tensor(x), torch.tensor(same), tcfg)
    b = TL.apply_rope(torch.tensor(x), torch.tensor(pos[0]), tcfg)
    assert torch.equal(a, b)
    small = positions3(2, 24)
    want = jax.jit(lambda x, p: JL.apply_mrope(x, p, jcfg))(
        jnp.asarray(x), jnp.asarray(small))
    _close(TL.apply_mrope(torch.tensor(x), torch.tensor(small), tcfg), want,
           ROPE_ATOL)


@pytest.mark.parametrize("mode", MODES)
def test_forward_matches_reference(weights, mode):
    jp, tp = weights
    jcfg, tcfg = _cfgs(mode)
    _, emb, pos = _prompt(jp, np.random.default_rng(1), 2, 24)
    want = jax.jit(lambda p, b: japi.forward(p, b, jcfg))(
        jp, {"embeds": jnp.asarray(emb), "positions": jnp.asarray(pos)})
    got = api.forward(tp, {"embeds": torch.tensor(emb),
                           "positions": torch.tensor(pos)}, tcfg)
    assert got.shape == (2, 24, tcfg.padded_vocab)
    _close(got, want, LOGIT_ATOL)


@pytest.mark.parametrize("mode", MODES)
def test_prefill_decode_match_forward_and_reference(weights, mode):
    """The vlm case of ``tests/test_parity.py`` with a patch grid: prefill
    of 20 embeds, then four text tokens decoded at flat positions 20-23,
    against the port's ``forward`` over all 24 (exact mode) and against
    the JAX prefill/decode logits (both modes), 1e-4."""
    jp, tp = weights
    jcfg, tcfg = _cfgs(mode)
    toks, emb, pos = _prompt(jp, np.random.default_rng(2), 2, 24)
    s, extra = 20, 4
    full = api.forward(tp, {"embeds": torch.tensor(emb),
                            "positions": torch.tensor(pos)}, tcfg).numpy()
    batch = {"embeds": emb[:, :s], "positions": pos[:, :, :s]}
    lg, cache = api.prefill(tp, {k: torch.tensor(v) for k, v in batch.items()},
                            tcfg, s + extra)
    jlg, jcache = jax.jit(lambda p, b: JV.prefill(p, b, jcfg, s + extra))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    _close(lg, jlg, LOGIT_ATOL)
    if mode == "exact":
        _close(lg[:, 0], full[:, s - 1], LOGIT_ATOL)
    jstep = jax.jit(lambda p, c, t, q: JV.decode_step(p, c, t, q, jcfg))
    for i in range(extra):
        lg, cache = api.decode_step(tp, cache, torch.tensor(toks[:, s + i]),
                                    s + i, tcfg)
        jlg, jcache = jstep(jp, jcache, jnp.asarray(toks[:, s + i]),
                            jnp.asarray(s + i, jnp.int32))
        _close(lg, jlg, LOGIT_ATOL)
        if mode == "exact":
            _close(lg, full[:, s + i], LOGIT_ATOL)
    _close(cache["k"], jcache["k"], 1e-5)
    assert np.array_equal(cache["pos"].numpy(), np.asarray(jcache["pos"]))


def test_decode_attend_stacked_positions3(weights):
    """The M-RoPE branch of ``decode_attend_stacked`` on one layer's
    stacked caches: output and the new K/V column as the reference's."""
    jp, tp = weights
    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(3)
    b, t, pos = 2, 12, 7
    x = rng.standard_normal((b, 1, 64)).astype(np.float32)
    ck = rng.standard_normal((2, b, 2, 16, t)).astype(np.float32)
    cv = rng.standard_normal((2, b, 2, t, 16)).astype(np.float32)
    cpos = np.where(np.arange(t) <= pos, np.arange(t), 2 ** 30).astype(
        np.int32)
    p3 = np.full((3, b, 1), pos, np.int32)
    ja = jax.tree.map(lambda a: a[1], jp["layers"]["attn"])
    ta = {k: v[1] for k, v in tp["layers"]["attn"].items()}
    want = jax.jit(lambda p, x, ck, cv, cp, q3: JL.decode_attend_stacked(
        p, x, ck, cv, cp, 1, jnp.asarray(pos, jnp.int32), jcfg,
        positions3=q3))(ja, *map(jnp.asarray, (x, ck, cv, cpos, p3)))
    got = TL.decode_attend_stacked(ta, torch.tensor(x), torch.tensor(ck),
                                   torch.tensor(cv), torch.tensor(cpos), 1,
                                   torch.tensor(pos, dtype=torch.int32), tcfg,
                                   min(pos, t - 1),
                                   positions3=torch.tensor(p3))
    for g, w in zip(got, want):
        _close(g, w, 1e-5)


def test_engines_refuse_vlm_like_reference(weights):
    """Both engines refuse the family with the reference's ``ValueError``
    (``PagedEngine``: not paged-servable; ``Engine``: LM families only),
    as the JAX engines do; so does every paged entry of the API."""
    jp, tp = weights
    jcfg, tcfg = _cfgs()
    for make in (lambda: JaxPaged(jcfg, jp),
                 lambda: PagedEngine(tcfg, tp, device="cpu")):
        with pytest.raises(ValueError, match="not paged-servable"):
            make()
    for make in (lambda: JaxDense(jcfg, jp),
                 lambda: Engine(tcfg, tp, device="cpu")):
        with pytest.raises(ValueError, match="Engine serves LM families"):
            make()
    assert not api.sequence_state_spec(tcfg).servable
    assert api.sequence_state_spec(tcfg) == dataclasses.replace(
        api.sequence_state_spec(tcfg), family="vlm", servable=False)
    one = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="not paged-servable"):
        api.decode_step_paged(tp, one, one, {}, {}, tcfg)
