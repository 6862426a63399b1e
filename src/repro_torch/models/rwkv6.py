"""RWKV-6 "Finch" [arXiv:2404.05892]: attention-free token mixing with a
data-dependent decay. Counterpart of ``repro/models/rwkv6.py``: parameter
init, the full-sequence forward, the dense-slot serve path (whole-prompt
prefill, one-token decode steps on stacked per-layer state) and the paged
serve path, whose per-sequence state lives in the slots of a
``StateSlotPool`` (``refs["slots"]``, slot 0 the null slot).

E2Softmax has no place here (no softmax in the block); AILayerNorm is the
pre-norms and the per-head GroupNorm, whose (H, hd) affine the norm
kernels take as a (G, C) affine over rows of one head's channels.

The WKV recurrence ``S_t = diag(w_t) S_{t-1} + k_t^T v_t`` runs in float32
as torch ops, one step per token (:func:`wkv_sequential`, the reference's
``lax.scan``; it has no Pallas kernel there), or chunk-parallel
(:func:`wkv_chunked`) when ``cfg.rwkv_chunk`` divides the sequence. The
reference's dtypes are kept: ``w0``, ``w1``, ``w2``, ``u`` and the WKV
state are float32, ``dw`` is computed from ``xw`` in float32, and the
token-shift rows are stored in float32 and read back in the model dtype.
The step's ``u * kv + S`` and ``w * S + kv`` are fused multiply-adds, as
XLA contracts them inside ``jit`` (``layers.fma``), so the carried state
is the compiled reference's bit for bit; the read-out contraction over hd
sums in another order, so the WKV outputs agree to a float32 tolerance.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import ops
from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models.state import SequenceStateSpec, sds, tree_map
from repro_torch.roofline.cost import Trips
from repro_torch.models.transformer import (_layer, _norm, _normal,
                                            remat_wrap, stacked)
from repro_torch.serve.sampling import eos_hits, sample_tokens

LORA_R = 32      # token-shift lora rank
DECAY_R = 64     # decay lora rank


def init(gen: torch.Generator, cfg: ArchConfig, device) -> Dict:
    """Random weights with the reference's tree, shapes and scales (normal
    x 0.02, the head x d_model^-0.5, ``w0`` -6, the token-shift ``mu`` and
    the GroupNorm's ``gn_b`` zero, ``gn_g`` one), each leaf stored once in
    the dtype the reference computes with: float32 for ``w0``/``w1``/
    ``w2``/``u`` and the norms, ``cfg.dtype`` for the rest."""
    dt = L.torch_dtype(cfg.dtype)
    f32 = torch.float32
    n, d, f = cfg.n_layers, cfg.d_model, cfg.d_ff
    h, hd = cfg.n_heads, cfg.rwkv_head_size

    def w(shape, dtype=dt, scale=0.02):
        return stacked(lambda s: _normal(gen, s, scale, dtype, device), n,
                       shape, dtype, device)

    def zeros(shape, dtype=dt):
        return torch.zeros((n,) + tuple(shape), dtype=dtype, device=device)

    tm = {"mu_x": zeros((d,)), "mu": zeros((5, d)),
          "lora_a": w((d, 5 * LORA_R)), "lora_b": w((5, LORA_R, d)),
          "w0": torch.full((n, d), -6.0, dtype=f32, device=device),
          "w1": w((d, DECAY_R), f32), "w2": w((DECAY_R, d), f32),
          "wr": w((d, h, hd)), "wk": w((d, h, hd)), "wv": w((d, h, hd)),
          "wg": w((d, h, hd)), "u": w((h, hd), f32), "wo": w((h, hd, d)),
          "gn_g": torch.ones((n, h, hd), dtype=f32, device=device),
          "gn_b": zeros((h, hd), f32)}
    cm = {"mu_k": zeros((d,)), "mu_r": zeros((d,)), "wk": w((d, f)),
          "wv": w((f, d)), "wr": w((d, d))}
    v = cfg.padded_vocab
    return {
        "embed": {"table": _normal(gen, (v, d), 0.02, dt, device),
                  "head": _normal(gen, (d, v), d ** -0.5, dt, device)},
        "layers": {"ln1": _norm(cfg, (n,), device), "tm": tm,
                   "ln2": _norm(cfg, (n,), device), "cm": cm},
        "final_norm": _norm(cfg, (), device),
    }


def _group_norm(o, g, b, cfg: ArchConfig, phase: str) -> torch.Tensor:
    """Per-head LayerNorm over head_dim: o (B, S, H, hd) float32 with an
    (H, hd) affine; SOLE AIGroupNorm when serving. Float32 out."""
    mode = L._norm_mode(cfg, phase)
    return ops.layernorm_fn(mode, o.device, cfg.ops_backend)(o, g, b)


def _shift(x, last) -> torch.Tensor:
    """Token shift: the previous timestep's activation (``last`` at t=0)."""
    return torch.cat([last[:, None], x[:, :-1]], 1)


def wkv_sequential(r, k, v, w, u, state):
    """The WKV recurrence one step per token: r/k/v/w (B, S, H, hd)
    float32, u (H, hd), state (B, H, hd, hd). Returns (o (B, S, H, hd),
    state). ``u * kv + S`` and ``w * S + kv`` are single-rounding FMAs, as
    the compiled reference contracts them; four launches per token on the
    card."""
    uu = u[None, :, :, None]
    outs = []
    loop = Trips(r.shape[1], r.device)   # two trips on meta, counted S
    for t in loop:
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]   # rank-1 update
        outs.append(torch.matmul(r[:, t, :, None, :],
                                 L.fma(uu, kv, state))[:, :, 0])
        state = L.fma(w[:, t, :, :, None], state, kv)
        loop.carry(state)
    return torch.stack(loop.kept(outs), 1), state


def wkv_chunked(r, k, v, w, u, state, chunk: int):
    """Chunk-parallel WKV (the reference's ``_wkv_chunked``): with L_t =
    cumsum(log w) per k-channel, every exponential is of a difference of
    cumulative negative logs along time, so exp(<= 0) only:

      inter:  o_t += (r_t * e^{L_{t-1}}) . S_in
      intra:  s_{t,tau} = sum_d r_td k_taud e^{L_{t-1,d} - L_{tau,d}},
              tau < t; the diagonal takes the u bonus;
      state:  S_out = e^{L_C} * S_in + sum_tau (k_tau e^{L_C - L_tau})^T v_tau
    """
    b, s, h, hd = r.shape
    nc = s // chunk

    def resh(a):  # (B, S, H, hd) -> (nc, B, H, C, hd)
        return a.reshape(b, nc, chunk, h, hd).permute(1, 0, 3, 2, 4)

    rc, kc, vc = resh(r), resh(k), resh(v)
    logw = torch.log(torch.clamp_min(resh(w), 1e-38))
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=r.device), diagonal=-1)
    outs = []
    loop = Trips(nc, r.device)         # two trips on meta, counted nc
    for i in loop:
        rt, kt, vt, lw = rc[i], kc[i], vc[i], logw[i]
        cum = torch.cumsum(lw, 2)                        # L_t
        prev = cum - lw                                  # L_{t-1}
        o = torch.einsum("bhtd,bhdv->bhtv", rt * torch.exp(prev), state)
        p = torch.exp(prev[:, :, :, None, :] - cum[:, :, None, :, :])
        scores = torch.einsum("bhtsd,bhsd->bhts", rt[:, :, :, None, :] * p,
                              kt)
        scores = torch.where(tri, scores, 0.0)
        diag = torch.einsum("bhtd,bhtd->bht", rt * u[None, :, None, :], kt)
        o = o + torch.einsum("bhts,bhsv->bhtv", scores, vt)
        o = o + diag[..., None] * vt
        decay_out = torch.exp(cum[:, :, -1])             # (B, H, hd)
        kd = kt * torch.exp(cum[:, :, -1:, :] - cum)     # k_tau e^{L_C - L_tau}
        state = decay_out[..., None] * state + torch.einsum(
            "bhsd,bhsv->bhdv", kd, vt)
        loop.carry(state)
        outs.append(o)
    o = torch.stack(loop.kept(outs)).permute(1, 0, 3, 2, 4).reshape(
        b, s, h, hd)
    return o, state


def time_mix(p, x, last_x, state, cfg: ArchConfig, phase: str,
             mask: Optional[torch.Tensor] = None):
    """x (B, S, D); last_x (B, D); state (B, H, hd, hd) float32. Returns
    (out, last row of x, state).

    ``mask`` (B, S) marks real tokens in a padded chunk (paged serving):
    padded positions get decay w := 1 and k := 0, an exact identity WKV
    step (S_new = 1 * S + 0), so the carried state is the state after the
    real tokens alone; padded outputs are garbage no caller reads."""
    b, s, _ = x.shape
    h, hd = cfg.n_heads, cfg.rwkv_head_size
    xx = _shift(x, last_x) - x
    xxx = x + xx * p["mu_x"]
    a = torch.tanh(xxx @ p["lora_a"]).reshape(b, s, 5, LORA_R)
    a = torch.einsum("bsnr,nrd->nbsd", a, p["lora_b"])
    mu = p["mu"]
    xw = x + xx * (mu[0] + a[0])
    xk = x + xx * (mu[1] + a[1])
    xv = x + xx * (mu[2] + a[2])
    xr = x + xx * (mu[3] + a[3])
    xg = x + xx * (mu[4] + a[4])
    r = torch.einsum("bsd,dhk->bshk", xr, p["wr"])
    k = torch.einsum("bsd,dhk->bshk", xk, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", xv, p["wv"])
    g = F.silu(torch.einsum("bsd,dhk->bshk", xg, p["wg"]))
    # data-dependent decay w in (0, 1), float32 for the recurrence
    dw = torch.tanh(xw.float() @ p["w1"]) @ p["w2"]
    w = torch.exp(-torch.exp(p["w0"] + dw)).reshape(b, s, h, hd)
    rf, kf, vf = r.float(), k.float(), v.float()
    if mask is not None:
        m = mask[:, :, None, None]
        w = torch.where(m, w, 1.0)        # identity decay past the real tail
        kf = torch.where(m, kf, 0.0)      # the rank-1 update vanishes there
    chunk = cfg.rwkv_chunk
    if chunk and s % chunk == 0 and s > chunk:
        o, state = wkv_chunked(rf, kf, vf, w, p["u"], state, chunk)
    else:
        o, state = wkv_sequential(rf, kf, vf, w, p["u"], state)
    o = _group_norm(o, p["gn_g"], p["gn_b"], cfg, phase)
    o = o.to(g.dtype) * g
    out = torch.einsum("bshk,hkd->bsd", o, p["wo"])
    return out, x[:, -1], state


def channel_mix(p, x, last_x, cfg: ArchConfig) -> Tuple[torch.Tensor,
                                                        torch.Tensor]:
    xx = _shift(x, last_x) - x
    xk = x + xx * p["mu_k"]
    xr = x + xx * p["mu_r"]
    hidden = torch.square(F.relu(xk @ p["wk"]))
    out = torch.sigmoid(xr @ p["wr"]) * (hidden @ p["wv"])
    return out, x[:, -1]


def _empty_state(cfg: ArchConfig, b: int, device, layers: int = 0):
    """Zero per-layer state, (B, ...) leaves (with ``layers``: (L, B,
    ...))."""
    h, hd, d = cfg.n_heads, cfg.rwkv_head_size, cfg.d_model
    lead = (layers, b) if layers else (b,)
    f32 = torch.float32
    return {"tm_x": torch.zeros(lead + (d,), dtype=f32, device=device),
            "cm_x": torch.zeros(lead + (d,), dtype=f32, device=device),
            "s": torch.zeros(lead + (h, hd, hd), dtype=f32, device=device)}


def _layer_step(x, lp, st, cfg: ArchConfig, phase: str):
    """One layer over x (B, S, D) from state ``st`` (B, ...); returns (x,
    the new state)."""
    h = L.apply_norm(x, lp["ln1"], cfg, phase)
    tm_out, tm_x, s_new = time_mix(lp["tm"], h, st["tm_x"].to(h.dtype),
                                   st["s"], cfg, phase)
    x = x + tm_out
    h = L.apply_norm(x, lp["ln2"], cfg, phase)
    cm_out, cm_x = channel_mix(lp["cm"], h, st["cm_x"].to(h.dtype), cfg)
    x = x + cm_out
    return x, {"tm_x": tm_x.float(), "cm_x": cm_x.float(), "s": s_new}


def forward(params, tokens, cfg: ArchConfig, phase: str) -> torch.Tensor:
    """tokens (B, S) -> logits (B, S, padded_vocab) float32, every layer
    from zero state."""
    x = L.embed_tokens(params["embed"], tokens, cfg)
    st0 = _empty_state(cfg, tokens.shape[0], tokens.device)

    def body(x, lp):
        return _layer_step(x, lp, st0, cfg, phase)[0]

    body = remat_wrap(body, cfg, phase)
    for i in range(cfg.n_layers):
        x = body(x, _layer(params["layers"], i))
    x = L.apply_norm(x, params["final_norm"], cfg, phase)
    return L.lm_logits(params["embed"], x, cfg)


# -- dense-slot serving --------------------------------------------------------


def init_cache(cfg: ArchConfig, batch: int, length: int, device):
    """Zero stacked state (L, B, ...): O(1) in the sequence length."""
    return _empty_state(cfg, batch, device, layers=cfg.n_layers)


def prefill(params, tokens, cfg: ArchConfig, cache_len: int = 0,
            n_pad=None):
    """Run the whole prompt (B, S) from zero state. Returns (last
    position's logits (B, 1, V), stacked state). Left padding is not
    masked (``n_pad`` is ignored): the reference's recurrent families
    share positions across lanes, so pad tokens run through the state."""
    x = L.embed_tokens(params["embed"], tokens, cfg)
    st0 = _empty_state(cfg, tokens.shape[0], tokens.device)
    states = []
    for i in range(cfg.n_layers):
        x, st = _layer_step(x, _layer(params["layers"], i), st0, cfg,
                            "serve")
        states.append(st)
    x = L.apply_norm(x, params["final_norm"], cfg, "serve")
    cache = {k: torch.stack([st[k] for st in states]) for k in st0}
    return L.lm_logits(params["embed"], x[:, -1:], cfg), cache


def decode_step(params, cache, token, pos, cfg: ArchConfig, write_pos=None):
    """One token per lane (B,) through every layer's state; ``pos`` is
    unused (no positional encoding). The stacked state (L, B, ...) is
    updated in place. Returns (logits (B, V), cache)."""
    x = L.embed_tokens(params["embed"], token[:, None], cfg)
    for i in range(cfg.n_layers):
        st = {k: v[i] for k, v in cache.items()}
        x, new = _layer_step(x, _layer(params["layers"], i), st, cfg,
                             "serve")
        for k, v in new.items():
            cache[k][i] = v
    x = L.apply_norm(x, params["final_norm"], cfg, "serve")
    return L.lm_logits(params["embed"], x, cfg)[:, 0], cache


# -- paged serving (per-sequence state slots; serve/state.py) ------------------
#
# A sequence's whole state is O(1): per layer a (H, hd, hd) WKV matrix and
# the two token-shift rows, parked in one slot of the engine's pool. The
# paged entries gather the lanes' slot rows, advance them and scatter them
# back. Every op is per position or a strict left-to-right scan, so chunked
# prefill computes what the whole prompt computes.


def sequence_state_spec(cfg: ArchConfig) -> SequenceStateSpec:
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.rwkv_head_size
    nl = cfg.n_layers
    f32 = torch.float32
    return SequenceStateSpec(
        family="ssm", kv_layers=0,
        slot_shapes={"tm_x": sds((nl, d), f32), "cm_x": sds((nl, d), f32),
                     "s": sds((nl, h, hd, hd), f32)},
        slot_axes={"tm_x": ("layers", "embed"), "cm_x": ("layers", "embed"),
                   "s": ("layers", "heads", "head_dim", None)},
        # a prefix hit restores a block-boundary checkpoint instead of
        # sharing pages; speculative decoding would need to rewind S.
        supports_prefix_cache=True, supports_spec_decode=False,
        supports_cow_fork=False, window=0)


def _last_valid(x, n_valid) -> torch.Tensor:
    """Row ``n_valid - 1`` of each lane: (B, S, D), (B,) -> (B, D)."""
    return x[torch.arange(x.shape[0], device=x.device), n_valid.long() - 1]


def _layer_paged(x, lp, st, n_valid, cfg: ArchConfig):
    """One layer over a padded chunk: as :func:`_layer_step`, but the
    carried state stops at ``n_valid`` (identity WKV updates past it, the
    shift rows read at the last real row)."""
    mask = (torch.arange(x.shape[1], device=x.device)[None]
            < n_valid[:, None])
    h = L.apply_norm(x, lp["ln1"], cfg, "serve")
    tm_out, _, s_new = time_mix(lp["tm"], h, st["tm_x"].to(h.dtype),
                                st["s"], cfg, "serve", mask=mask)
    x = x + tm_out
    h2 = L.apply_norm(x, lp["ln2"], cfg, "serve")
    cm_out, _ = channel_mix(lp["cm"], h2, st["cm_x"].to(h2.dtype), cfg)
    x = x + cm_out
    return x, {"tm_x": _last_valid(h, n_valid).float(),
               "cm_x": _last_valid(h2, n_valid).float(), "s": s_new}


def _gather_slots(state, refs):
    """Slot pool (N, L, ...) -> the lanes' rows in layer-major layout (L,
    B, ...), a copy."""
    sid = refs["slots"].long()
    return tree_map(lambda s: s[sid].transpose(0, 1).contiguous(),
                    state["slots"])


def _scatter_slots(state, refs, st):
    """Write the lanes' (L, B, ...) states back into their slot rows, in
    place. Padded lanes all target the null slot 0, whose content is
    garbage by contract."""
    sid = refs["slots"].long()

    def put(s, r):
        s[sid] = r.transpose(0, 1).to(s.dtype)
        return s
    return {"slots": tree_map(put, state["slots"], st)}


def prefill_paged(params, tokens, q_start, n_valid, refs, state,
                  cfg: ArchConfig):
    """One chunked-prefill step: advance each lane's slot state by its
    ``n_valid`` real tokens (``q_start`` unused: no positional encoding).
    Returns (logits (B, C, V), state)."""
    st = _gather_slots(state, refs)
    x = L.embed_tokens(params["embed"], tokens, cfg)
    new = []
    for i in range(cfg.n_layers):
        x, sti = _layer_paged(x, _layer(params["layers"], i),
                              {k: v[i] for k, v in st.items()}, n_valid, cfg)
        new.append(sti)
    x = L.apply_norm(x, params["final_norm"], cfg, "serve")
    logits = L.lm_logits(params["embed"], x, cfg)
    stacked_new = {k: torch.stack([s[k] for s in new]) for k in st}
    return logits, _scatter_slots(state, refs, stacked_new)


def decode_step_paged(params, token, pos, refs, state, cfg: ArchConfig):
    """One decode step over slot state (``pos`` unused). Returns (logits
    (B, V), state)."""
    st = _gather_slots(state, refs)
    logits, st = decode_step(params, st, token, pos, cfg)
    return logits, _scatter_slots(state, refs, st)


def decode_horizon_paged(params, token, pos, refs, state, temperature,
                         top_k, seed, counter, eos_ids, cfg: ArchConfig, *,
                         num_steps: int, use_top_k: bool = True,
                         stochastic: bool = True, use_eos: bool = True):
    """``num_steps`` decode steps, each sampling its token on the device
    and feeding it to the next (the sampling and eos contract of the
    transformer's horizon). The slot rows are gathered once, carried
    through the steps and scattered back once: slot traffic per horizon,
    not per token. Returns (tokens (B, num_steps), eos (B, num_steps),
    state)."""
    st = _gather_slots(state, refs)
    toks, done = [], []
    for i in range(num_steps):
        logits, st = decode_step(params, st, token, pos, cfg)
        token = sample_tokens(logits, temperature, top_k, seed,
                              counter + i if stochastic else counter,
                              cfg.vocab_size, use_top_k=use_top_k,
                              stochastic=stochastic)
        toks.append(token)
        done.append(eos_hits(token, eos_ids) if use_eos
                    else torch.zeros_like(token, dtype=torch.bool))
    return (torch.stack(toks, 1), torch.stack(done, 1),
            _scatter_slots(state, refs, st))
