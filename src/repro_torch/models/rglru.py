"""RecurrentGemma / Griffin hybrid [arXiv:2402.19427]: n x (rec, rec,
local-attention) blocks and trailing recurrent layers (recurrentgemma_9b:
12 blocks + 2, 26:12). Counterpart of ``repro/models/rglru.py``: init,
the full-sequence forward, the dense-slot serve path (whole-prompt prefill
into rolling window caches, one-token decode steps) and the paged serve
path, whose attention blocks page their K/V (pool layer = block index)
while the RG-LRU hidden and causal-conv state of every recurrent layer
lives in a ``StateSlotPool`` slot.

The RG-LRU recurrence ``h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t * x_t)``
is the reference's ``jax.lax.associative_scan``, whose float reduction
tree depends on the sequence length: :func:`associative_scan` is a copy of
its even/odd recursion, so the same chunk gives the same tree. Inside
``jit`` XLA contracts the combine's ``a2 * b1 + b2`` into a fused
multiply-add; the port takes it as one too (``layers.fma``). The causal
depthwise conv (width 4) is shift-and-multiply-accumulate. Pages are
append-only, so the paged engine serves only while ``max_seq_len <=
cfg.window``: the window never binds and the paged computation is the
windowed oracle's.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models.state import SequenceStateSpec, sds, tree_map
from repro_torch.models import transformer as T
from repro_torch.models.transformer import _layer, _norm, _normal, stacked
from repro_torch.serve.kv_cache import slots_for_positions, write_tokens
from repro_torch.serve.sampling import eos_hits, sample_tokens


def n_blocks(cfg: ArchConfig) -> int:
    return (cfg.n_layers - cfg.n_tail_layers) // len(cfg.block_pattern)


def _init_stack(gen, cfg: ArchConfig, device, n: int, kind: str) -> Dict:
    """``n`` stacked recurrent (``kind="rec"``) or attention layers, each
    leaf in the dtype the reference computes with (``lam`` and the norms
    float32, the rest ``cfg.dtype``)."""
    dt = L.torch_dtype(cfg.dtype)
    d, f = cfg.d_model, cfg.d_ff

    def w(shape, dtype=dt):
        return stacked(lambda s: _normal(gen, s, 0.02, dtype, device), n,
                       shape, dtype, device)

    def full(shape, value, dtype=dt):
        return torch.full((n,) + tuple(shape), value, dtype=dtype,
                          device=device)

    mlp = {"up": w((d, f)), "down": w((f, d))}
    if cfg.mlp_kind in L.GATED_MLP_KINDS:
        mlp = {"gate": w((d, f)), **mlp}
    if kind == "attn":
        h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        attn = {"wq": w((d, h, hd)), "wk": w((d, kv, hd)),
                "wv": w((d, kv, hd)), "wo": w((h, hd, d))}
        if cfg.qkv_bias:
            attn.update(bq=full((h, hd), 0.0), bk=full((kv, hd), 0.0),
                        bv=full((kv, hd), 0.0))
        return {"ln": _norm(cfg, (n,), device), "attn": attn,
                "ln_mlp": _norm(cfg, (n,), device), "mlp": mlp}
    return {"ln": _norm(cfg, (n,), device), "in_x": w((d, d)),
            "in_gate": w((d, d)), "conv_w": w((cfg.conv_width, d)),
            "conv_b": full((d,), 0.0), "wa": w((d, d)),
            "ba": full((d,), 2.0), "wx": w((d, d)), "bx": full((d,), 0.0),
            "lam": full((d,), 0.7, torch.float32), "out": w((d, d)),
            "ln_mlp": _norm(cfg, (n,), device), "mlp": mlp}


def init(gen: torch.Generator, cfg: ArchConfig, device) -> Dict:
    """Random weights with the reference's tree, shapes and scales (normal
    x 0.02, the head x d_model^-0.5, ``ba`` 2, ``lam`` 0.7, biases zero,
    norms ones), each leaf stored once in its serving dtype."""
    dt = L.torch_dtype(cfg.dtype)
    nb, d, v = n_blocks(cfg), cfg.d_model, cfg.padded_vocab
    return {
        "embed": {"table": _normal(gen, (v, d), 0.02, dt, device),
                  "head": _normal(gen, (d, v), d ** -0.5, dt, device)},
        "blocks": {"rec1": _init_stack(gen, cfg, device, nb, "rec"),
                   "rec2": _init_stack(gen, cfg, device, nb, "rec"),
                   "attn": _init_stack(gen, cfg, device, nb, "attn")},
        "tail": _init_stack(gen, cfg, device, cfg.n_tail_layers, "rec"),
        "final_norm": _norm(cfg, (), device),
    }


def _combine(a1, b1, a2, b2):
    return a1 * a2, L.fma(a2, b1, b2)


def _interleave(even, odd):
    """Rows even[0], odd[0], even[1], ... along dim 1 (``even`` has as many
    rows as ``odd`` or one more)."""
    n = even.shape[1] + odd.shape[1]
    out = torch.empty((even.shape[0], n) + tuple(even.shape[2:]),
                      dtype=even.dtype, device=even.device)
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def associative_scan(a, b):
    """Inclusive scan of the pairs (a_t, b_t) along dim 1 under ``(a1, b1)
    o (a2, b2) = (a1 a2, a2 b1 + b2)``, by ``jax.lax.associative_scan``'s
    recursion: combine adjacent pairs, scan the half-length sequence, fill
    in the even elements, interleave. Returns the b component."""
    def scan(a, b):
        n = a.shape[1]
        if n < 2:
            return a, b
        ra, rb = _combine(a[:, 0:n - 1:2], b[:, 0:n - 1:2], a[:, 1::2],
                          b[:, 1::2])
        oa, ob = scan(ra, rb)
        if n % 2 == 0:
            ea, eb = _combine(oa[:, :-1], ob[:, :-1], a[:, 2::2], b[:, 2::2])
        else:
            ea, eb = _combine(oa, ob, a[:, 2::2], b[:, 2::2])
        ea = torch.cat([a[:, :1], ea], 1)
        eb = torch.cat([b[:, :1], eb], 1)
        return _interleave(ea, oa), _interleave(eb, ob)
    return scan(a, b)[1]


def _causal_conv(x, w, b, conv_state=None, n_valid=None):
    """Depthwise causal conv by shifted adds: x (B, S, D), w (W, D),
    ``conv_state`` (B, W-1, D) the previous inputs. With ``n_valid`` (B,)
    (a padded chunk) the carried state is the W-1 inputs ending at the last
    real token rather than the buffer tail. Returns (out + b, state).

    The taps add left to right as the compiled reference contracts its
    ``sum(xp[i] * w[W-1-i])``: the first add folds the first product into
    an FMA with the second, each later tap is an FMA onto the sum."""
    width, s = w.shape[0], x.shape[1]
    if conv_state is None:
        hist = torch.zeros((x.shape[0], width - 1, x.shape[2]),
                           dtype=x.dtype, device=x.device)
    else:
        hist = conv_state.to(x.dtype)
    xp = torch.cat([hist, x], 1)
    if width == 1:
        out = xp * w[0]
    else:
        out = L.fma(xp[:, 0:s], w[width - 1], xp[:, 1:1 + s] * w[width - 2])
        for i in range(2, width):
            out = L.fma(xp[:, i:i + s], w[width - 1 - i], out)
    if n_valid is None:
        new_state = xp[:, -(width - 1):]
    else:
        # real inputs sit at xp rows [W-1, W-1 + n_valid): the W-1 rows of
        # context ending there are xp[n_valid : n_valid + W-1]
        idx = (n_valid[:, None].long()
               + torch.arange(width - 1, device=x.device)[None])
        new_state = xp[torch.arange(x.shape[0], device=x.device)[:, None],
                       idx]
    return out + b, new_state


def _softplus(x):
    """``jax.nn.softplus`` (``logaddexp(x, 0)``): max(x, 0) + log1p(exp(-|x|))."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def rg_lru(x, r_in, p, cfg: ArchConfig, h0=None, mask=None):
    """RG-LRU over (B, S, D); ``h0`` (B, D) the initial state, folded in as
    a virtual first step. The gate matmuls and sigmoids run in the model
    dtype, the decay and the recurrence in float32. ``mask`` (B, S) marks
    real tokens in a padded chunk: padded positions get a := 1 and gated
    := 0, an exact identity step, so the last state is the one at the last
    real token. Returns (y in x's dtype, h_last float32)."""
    xf = x.float()
    r = torch.sigmoid(r_in @ p["wa"] + p["ba"]).float()
    i = torch.sigmoid(r_in @ p["wx"] + p["bx"]).float()
    a = torch.exp(-cfg.rglru_c * _softplus(p["lam"]) * r)
    gated = torch.sqrt(torch.clamp_min(L.fma(-a, a, torch.ones_like(a)),
                                       1e-12)) * (i * xf)
    if mask is not None:
        m = mask[:, :, None]
        a = torch.where(m, a, 1.0)
        gated = torch.where(m, gated, 0.0)
    if h0 is not None:
        a = torch.cat([torch.ones_like(a[:, :1]), a], 1)
        gated = torch.cat([h0.float()[:, None], gated], 1)
    h = associative_scan(a, gated)
    if h0 is not None:
        h = h[:, 1:]
    return h.to(x.dtype), h[:, -1]


def recurrent_block(p, x, cfg: ArchConfig, phase: str,
                    state: Optional[Dict] = None, n_valid=None):
    """Griffin recurrent layer and its MLP residual; ``state`` {"h",
    "conv"} (None: from nothing, no virtual first step). ``n_valid`` (B,)
    freezes the carried state at the last real token of a padded chunk.
    Returns (x, {"h", "conv"} float32)."""
    h = L.apply_norm(x, p["ln"], cfg, phase)
    bx = h @ p["in_x"]
    bg = F.gelu(h @ p["in_gate"], approximate="tanh")
    conv_state = None if state is None else state["conv"]
    bx, conv_new = _causal_conv(bx, p["conv_w"], p["conv_b"], conv_state,
                                n_valid=n_valid)
    h0 = None if state is None else state["h"]
    mask = (None if n_valid is None
            else torch.arange(x.shape[1], device=x.device)[None]
            < n_valid[:, None])
    y, h_last = rg_lru(bx, bx, p, cfg, h0, mask=mask)
    x = x + (y * bg) @ p["out"]
    hh = L.apply_norm(x, p["ln_mlp"], cfg, phase)
    x = x + L.apply_mlp(hh, p["mlp"], cfg)
    return x, {"h": h_last.float(), "conv": conv_new.float()}


def attn_block(p, x, positions, cfg: ArchConfig, phase: str):
    h = L.apply_norm(x, p["ln"], cfg, phase)
    x = x + L.apply_attention(p["attn"], h, positions, cfg, phase)
    hh = L.apply_norm(x, p["ln_mlp"], cfg, phase)
    return x + L.apply_mlp(hh, p["mlp"], cfg)


def forward(params, tokens, cfg: ArchConfig, phase: str) -> torch.Tensor:
    """tokens (B, S) -> logits (B, S, padded_vocab) float32."""
    x = L.embed_tokens(params["embed"], tokens, cfg)
    positions = torch.arange(tokens.shape[1], device=tokens.device)

    def block(x, bp):
        x, _ = recurrent_block(bp["rec1"], x, cfg, phase)
        x, _ = recurrent_block(bp["rec2"], x, cfg, phase)
        return attn_block(bp["attn"], x, positions, cfg, phase)

    def tail(x, tp):
        return recurrent_block(tp, x, cfg, phase)[0]

    block, tail = (T.remat_wrap(f, cfg, phase) for f in (block, tail))
    for i in range(n_blocks(cfg)):
        x = block(x, _layer(params["blocks"], i))
    for i in range(cfg.n_tail_layers):
        x = tail(x, _layer(params["tail"], i))
    x = L.apply_norm(x, params["final_norm"], cfg, phase)
    return L.lm_logits(params["embed"], x, cfg)


# -- dense-slot serving --------------------------------------------------------


def _empty_rec_state(cfg: ArchConfig, b: int, device, lead=()):
    f32 = torch.float32
    return {"h": torch.zeros(tuple(lead) + (b, cfg.d_model), dtype=f32,
                             device=device),
            "conv": torch.zeros(tuple(lead) + (b, cfg.conv_width - 1,
                                               cfg.d_model),
                                dtype=f32, device=device)}


def init_cache(cfg: ArchConfig, batch: int, length: int, device):
    """Zero recurrent state per layer and empty rolling window caches
    (B, min(length, window), KV, hd) per attention block, stacked."""
    nb = n_blocks(cfg)
    t = min(length, cfg.window) if cfg.window else length
    dt = L.kv_store_dtype(cfg)
    kv = (nb, batch, t, cfg.n_kv_heads, cfg.head_dim)
    return {"blocks": {
                "rec1": _empty_rec_state(cfg, batch, device, (nb,)),
                "rec2": _empty_rec_state(cfg, batch, device, (nb,)),
                "attn": {"k": torch.zeros(kv, dtype=dt, device=device),
                         "v": torch.zeros(kv, dtype=dt, device=device),
                         "pos": torch.full((nb, t), 2 ** 30,
                                           dtype=torch.int32,
                                           device=device)}},
            "tail": _empty_rec_state(cfg, batch, device,
                                     (cfg.n_tail_layers,)),
            "pos": 0}


def _stack(states: List[Dict], empty: Dict, dim: int = 0) -> Dict:
    """Per-layer {"h", "conv"} -> stacked along a new ``dim`` (``empty``
    where there are no layers)."""
    if not states:
        return empty
    return {k: torch.stack([s[k] for s in states], dim) for k in empty}


def _window_cache(k, v, positions, t: int, cfg: ArchConfig):
    """One block's prefill K/V (B, S, KV, hd) -> the rolling window cache
    of ``t`` columns and its positions (padded columns hold 2**30)."""
    s = k.shape[1]
    if s >= t:
        kk, vv, pp = k[:, -t:], v[:, -t:], positions[-t:]
        shift = s % t
    else:
        kk = F.pad(k, (0, 0, 0, 0, 0, t - s))
        vv = F.pad(v, (0, 0, 0, 0, 0, t - s))
        pp = F.pad(positions, (0, t - s), value=2 ** 30)
        shift = 0
    dt = L.torch_dtype(cfg.dtype)
    return {"k": torch.roll(kk, shift, 1).to(dt),
            "v": torch.roll(vv, shift, 1).to(dt),
            "pos": torch.roll(pp, shift, 0).to(torch.int32)}


def prefill(params, tokens, cfg: ArchConfig, cache_len: int, n_pad=None):
    """Run the whole prompt (B, S) from zero state (shared positions: left
    padding, ``n_pad``, is not masked, as in the reference). Returns (last
    position's logits (B, 1, V), cache)."""
    b, s = tokens.shape
    dev = tokens.device
    x = L.embed_tokens(params["embed"], tokens, cfg)
    positions = torch.arange(s, device=dev)
    t = min(cache_len, cfg.window) if cfg.window else cache_len
    bl = params["blocks"]
    rec1, rec2, kvs = [], [], []
    for i in range(n_blocks(cfg)):
        x, st1 = recurrent_block(_layer(bl["rec1"], i), x, cfg, "serve",
                                 _empty_rec_state(cfg, b, dev))
        x, st2 = recurrent_block(_layer(bl["rec2"], i), x, cfg, "serve",
                                 _empty_rec_state(cfg, b, dev))
        ap = _layer(bl["attn"], i)
        h = L.apply_norm(x, ap["ln"], cfg, "serve")
        q, k, v = L._project_qkv(ap["attn"], h, cfg)
        if cfg.pos_kind == "rope":
            q = L.apply_rope(q, positions, cfg)
            k = L.apply_rope(k, positions, cfg)
        ctx = L.attend_dense(q, k, v, positions, positions, cfg, "serve")
        x = x + L._wo_proj(ctx, ap["attn"], cfg)
        hh = L.apply_norm(x, ap["ln_mlp"], cfg, "serve")
        x = x + L.apply_mlp(hh, ap["mlp"], cfg)
        rec1.append(st1)
        rec2.append(st2)
        kvs.append(_window_cache(k, v, positions, t, cfg))
    tail = []
    for i in range(cfg.n_tail_layers):
        x, st = recurrent_block(_layer(params["tail"], i), x, cfg, "serve",
                                _empty_rec_state(cfg, b, dev))
        tail.append(st)
    x = L.apply_norm(x, params["final_norm"], cfg, "serve")
    logits = L.lm_logits(params["embed"], x[:, -1:], cfg)
    empty = init_cache(cfg, b, t, dev)
    attn = ({k: torch.stack([c[k] for c in kvs]) for k in kvs[0]} if kvs
            else empty["blocks"]["attn"])
    return logits, {"blocks": {"rec1": _stack(rec1, empty["blocks"]["rec1"]),
                               "rec2": _stack(rec2, empty["blocks"]["rec2"]),
                               "attn": attn},
                    "tail": _stack(tail, empty["tail"]), "pos": s}


def decode_step(params, cache, token, pos, cfg: ArchConfig, write_pos=None):
    """One token per lane (B,) at the shared position ``pos`` (an int or a
    scalar tensor). The cache is updated in place. Returns (logits (B, V),
    cache)."""
    pos = int(pos)
    x = L.embed_tokens(params["embed"], token[:, None], cfg)
    bl, cb = params["blocks"], cache["blocks"]

    def rec(p, x, c, i):
        x, st = recurrent_block(p, x, cfg, "serve",
                                {k: v[i] for k, v in c.items()})
        for k, v in st.items():
            c[k][i] = v
        return x

    for i in range(n_blocks(cfg)):
        x = rec(_layer(bl["rec1"], i), x, cb["rec1"], i)
        x = rec(_layer(bl["rec2"], i), x, cb["rec2"], i)
        ap = _layer(bl["attn"], i)
        h = L.apply_norm(x, ap["ln"], cfg, "serve")
        x = x + L.decode_attend(ap["attn"], h,
                                {k: v[i] for k, v in cb["attn"].items()},
                                pos, cfg)
        hh = L.apply_norm(x, ap["ln_mlp"], cfg, "serve")
        x = x + L.apply_mlp(hh, ap["mlp"], cfg)
    for i in range(cfg.n_tail_layers):
        x = rec(_layer(params["tail"], i), x, cache["tail"], i)
    x = L.apply_norm(x, params["final_norm"], cfg, "serve")
    cache["pos"] = pos + 1
    return L.lm_logits(params["embed"], x, cfg)[:, 0], cache


# -- paged serving (paged KV for the attention blocks + state slots) -----------


def sequence_state_spec(cfg: ArchConfig) -> SequenceStateSpec:
    d, w = cfg.d_model, cfg.conv_width
    nb, nt = n_blocks(cfg), cfg.n_tail_layers
    f32 = torch.float32

    def rec(n):
        return {"h": sds((n, d), f32), "conv": sds((n, w - 1, d), f32)}

    def rec_axes():
        return {"h": ("layers", "ff"), "conv": ("layers", None, "ff")}

    return SequenceStateSpec(
        family="hybrid", kv_layers=nb,
        slot_shapes={"blocks": {"rec1": rec(nb), "rec2": rec(nb)},
                     "tail": rec(nt)},
        slot_axes={"blocks": {"rec1": rec_axes(), "rec2": rec_axes()},
                   "tail": rec_axes()},
        # a prefix hit needs both an aligned page match and a state
        # checkpoint at the same boundary (the scheduler takes the min);
        # speculative decoding would need to rewind the LRU/conv state.
        supports_prefix_cache=True, supports_spec_decode=False,
        supports_cow_fork=False, window=cfg.window)


def _forward_rows(params, tokens, positions, n_valid, kv_len, tables, pools,
                  rows, cfg: ArchConfig, *, causal: bool):
    """C tokens per lane through the recurrent layers (state ``rows``, the
    lanes' gathered slot rows: leaves (B, n, ...)) and the paged attention
    blocks (write the chunk's K/V into ``pools`` in place, padded-tail
    writes routed to the null page, then attend). Returns (logits (B, C,
    V), the new rows)."""
    x = L.embed_tokens(params["embed"], tokens, cfg)
    q_start = positions[:, 0]
    nb = n_blocks(cfg)
    if nb:
        pk, pv = pools["k"], pools["v"]
        block_ids, offsets = slots_for_positions(positions, pk.shape[2],
                                                 tables)
        write_end = (q_start + n_valid)[:, None]
        block_ids = torch.where(positions < write_end, block_ids, 0)
    bl, rb = params["blocks"], rows["blocks"]

    def rec(p, x, r, i):
        return recurrent_block(p, x, cfg, "serve",
                               {k: v[:, i] for k, v in r.items()},
                               n_valid=n_valid)

    new1, new2 = [], []
    for i in range(nb):
        x, st1 = rec(_layer(bl["rec1"], i), x, rb["rec1"], i)
        x, st2 = rec(_layer(bl["rec2"], i), x, rb["rec2"], i)
        ap = _layer(bl["attn"], i)
        h = L.apply_norm(x, ap["ln"], cfg, "serve")
        q, k, v = L._project_qkv(ap["attn"], h, cfg)
        if cfg.pos_kind == "rope":
            q = L.apply_rope(q, positions, cfg)
            k = L.apply_rope(k, positions, cfg)
        write_tokens(pk[i], L.kv_quant(k, cfg), block_ids, offsets)
        write_tokens(pv[i], L.kv_quant(v, cfg), block_ids, offsets)
        ctx = L.paged_attend(q, pk[i], pv[i], tables, q_start, kv_len, cfg,
                             causal=causal)
        x = x + L._wo_proj(ctx, ap["attn"], cfg)
        hh = L.apply_norm(x, ap["ln_mlp"], cfg, "serve")
        x = x + L.apply_mlp(hh, ap["mlp"], cfg)
        new1.append(st1)
        new2.append(st2)
    newt = []
    for i in range(cfg.n_tail_layers):
        x, st = rec(_layer(params["tail"], i), x, rows["tail"], i)
        newt.append(st)
    x = L.apply_norm(x, params["final_norm"], cfg, "serve")
    logits = L.lm_logits(params["embed"], x, cfg)

    return logits, {"blocks": {"rec1": _stack(new1, rb["rec1"], 1),
                               "rec2": _stack(new2, rb["rec2"], 1)},
                    "tail": _stack(newt, rows["tail"], 1)}


def _gather(state, refs):
    """The lanes' slot rows (B, n, ...), a copy."""
    sid = refs["slots"].long()
    return tree_map(lambda s: s[sid], state["slots"])


def _scatter(state, refs, rows):
    """Write the lanes' rows back into their slots, in place (padded lanes
    all target the null slot 0, garbage by contract). Returns the state."""
    sid = refs["slots"].long()

    def put(s, r):
        s[sid] = r.to(s.dtype)
        return s
    tree_map(put, state["slots"], rows)
    return state


def _pools(state):
    return {k: state[k] for k in ("k", "v") if k in state}


def prefill_paged(params, tokens, q_start, n_valid, refs, state,
                  cfg: ArchConfig):
    """One chunked-prefill step: advance the lanes' slots by their
    ``n_valid`` real tokens and write the chunk's attention K/V. Returns
    (logits (B, C, V), state)."""
    c = tokens.shape[1]
    positions = q_start[:, None] + torch.arange(c, device=tokens.device)
    logits, rows = _forward_rows(
        params, tokens, positions, n_valid, q_start + n_valid,
        refs.get("tables"), _pools(state), _gather(state, refs), cfg,
        causal=True)
    return logits, _scatter(state, refs, rows)


def decode_step_paged(params, token, pos, refs, state, cfg: ArchConfig):
    """One decode step: token (B,) at positions (B,). Returns (logits (B,
    V), state)."""
    logits, rows = _forward_rows(
        params, token[:, None], pos[:, None], torch.ones_like(pos), pos + 1,
        refs.get("tables"), _pools(state), _gather(state, refs), cfg,
        causal=False)
    return logits[:, 0], _scatter(state, refs, rows)


def decode_horizon_paged(params, token, pos, refs, state, temperature,
                         top_k, seed, counter, eos_ids, cfg: ArchConfig, *,
                         num_steps: int, use_top_k: bool = True,
                         stochastic: bool = True, use_eos: bool = True):
    """``num_steps`` decode+sample steps (the transformer horizon's sampling
    and eos contract). The slot rows are gathered once, carried through the
    steps and scattered back once; the pages are written in place. Returns
    (tokens (B, num_steps), eos (B, num_steps), state)."""
    rows = _gather(state, refs)
    pools = _pools(state)
    tables = refs.get("tables")
    toks, done = [], []
    for i in range(num_steps):
        logits, rows = _forward_rows(
            params, token[:, None], pos[:, None], torch.ones_like(pos),
            pos + 1, tables, pools, rows, cfg, causal=False)
        token = sample_tokens(logits[:, 0], temperature, top_k, seed,
                              counter + i if stochastic else counter,
                              cfg.vocab_size, use_top_k=use_top_k,
                              stochastic=stochastic)
        toks.append(token)
        done.append(eos_hits(token, eos_ids) if use_eos
                    else torch.zeros_like(token, dtype=torch.bool))
        pos = pos + 1
    return (torch.stack(toks, 1), torch.stack(done, 1),
            _scatter(state, refs, rows))
