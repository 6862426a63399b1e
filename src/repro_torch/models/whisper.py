"""Whisper-small backbone (encoder-decoder), the counterpart of
``repro/models/whisper.py``. The log-mel conv frontend is a stub: callers
pass precomputed frame embeddings (B, S_enc, D) with their positional
information already folded in.

The encoder is non-causal self-attention over the frames; the decoder
adds sinusoidal positions to its token embeddings (no RoPE) and runs
causal self-attention, cross-attention over the encoder states and a
GELU MLP, each behind a LayerNorm. Every attention goes through
``layers.attend_dense`` (E2Softmax on the card in SOLE mode) or, for the
decoder's paged self-attention, ``layers.paged_attend``.

Serving: the dense-cache oracle (:func:`prefill`/:func:`decode_step`,
what the reference's own tests hold the paged path to) and the paged path.
There the encoder runs **once per request, at admission**
(:func:`encode_paged`): every decoder layer's cross K/V is written into
the request's private cross pages, in the same {"k", "v"} pool as the
decoder's self-attention pages. Prefill chunks and decode steps only read
them (:func:`_gather_cross`, once per call or decode horizon), so a
preempted request that loses its pages re-encodes on re-admission.

The sinusoid ``ang = pos / 10000 ** (2 * dim / d)`` is float32 on both
sides; torch's ``pow``/``sin``/``cos`` and XLA's round apart by an ulp, so
the rows agree with the reference's to a float32 tolerance, not bitwise.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.state import SequenceStateSpec
from repro_torch.serve.kv_cache import (gather_kv, slots_for_positions,
                                        write_tokens)
from repro_torch.serve.sampling import eos_hits, sample_tokens

NO_KEY = 2 ** 30                  # position of a padded (masked) key


def init(gen: torch.Generator, cfg: ArchConfig, device) -> Dict:
    """Random weights with the reference's tree, shapes and scales:
    ``enc_layers`` (ln1, attn, ln2, mlp) stacked over ``n_enc_layers``,
    ``enc_norm``, ``dec_layers`` (ln1, attn, ln_x, xattn, ln2, mlp)
    stacked over ``n_layers``, ``final_norm`` and the embedding/head."""
    w, mw = T._weights(gen, cfg, device)
    d, v = cfg.d_model, cfg.padded_vocab
    ne, nd = cfg.n_enc_layers, cfg.n_layers
    return {
        "embed": {"table": w((v, d)), "head": mw((d, v), d ** -0.5)},
        "enc_layers": {"ln1": T._norm(cfg, (ne,), device),
                       "attn": T.init_attention(mw, cfg, ne, device),
                       "ln2": T._norm(cfg, (ne,), device),
                       "mlp": T.init_mlp(gen, cfg, device, n=ne)},
        "enc_norm": T._norm(cfg, (), device),
        "dec_layers": {"ln1": T._norm(cfg, (nd,), device),
                       "attn": T.init_attention(mw, cfg, nd, device),
                       "ln_x": T._norm(cfg, (nd,), device),
                       "xattn": T.init_attention(mw, cfg, nd, device),
                       "ln2": T._norm(cfg, (nd,), device),
                       "mlp": T.init_mlp(gen, cfg, device, n=nd)},
        "final_norm": T._norm(cfg, (), device),
    }


def sin_rows(positions: torch.Tensor, d: int) -> torch.Tensor:
    """Sinusoidal position rows: positions (...,) -> (..., d) float32,
    ``[sin(ang), cos(ang)]`` with ``ang = pos / 10000 ** (2 * dim / d)``."""
    dim = torch.arange(d // 2, dtype=torch.float32, device=positions.device)
    ang = positions.float()[..., None] / torch.pow(10000.0, 2 * dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1)


def _sin_pos(s: int, d: int, device) -> torch.Tensor:
    return sin_rows(torch.arange(s, device=device), d)


def encode(params, frames, cfg: ArchConfig, phase: str) -> torch.Tensor:
    """frames (B, S_enc, D) -> encoder states (B, S_enc, D): non-causal
    self-attention layers, then the encoder norm. A SOLE norm calibrates
    over all B * S_enc rows of its call."""
    x = L.cast(frames, cfg)
    positions = torch.arange(x.shape[1], device=x.device)

    def layer(x, lp):
        h = L.apply_norm(x, lp["ln1"], cfg, phase)
        attn_out = L.apply_attention(lp["attn"], h, positions, cfg, phase,
                                     causal=False)
        x, h = L.apply_residual_norm(x, attn_out, lp["ln2"], cfg, phase)
        return x + L.apply_mlp(h, lp["mlp"], cfg)

    layer = T.remat_wrap(layer, cfg, phase)
    for i in range(cfg.n_enc_layers):
        x = layer(x, T._layer(params["enc_layers"], i))
    return L.apply_norm(x, params["enc_norm"], cfg, phase)


def decode(params, tokens, enc_out, cfg: ArchConfig,
           phase: str) -> torch.Tensor:
    """Decoder over the whole token sequence (B, S) against ``enc_out``:
    logits (B, S, padded_vocab) float32."""
    s = tokens.shape[1]
    x = L.embed_tokens(params["embed"], tokens, cfg)
    x = x + L.cast(_sin_pos(s, cfg.d_model, x.device), cfg)[None]
    positions = torch.arange(s, device=x.device)

    def layer(x, lp, enc_out):
        h = L.apply_norm(x, lp["ln1"], cfg, phase)
        attn_out = L.apply_attention(lp["attn"], h, positions, cfg, phase,
                                     causal=True)
        x, h = L.apply_residual_norm(x, attn_out, lp["ln_x"], cfg, phase)
        kv = L.cross_kv(lp["xattn"], enc_out, cfg)
        xattn_out = L.apply_cross_attention(lp["xattn"], h, kv, cfg, phase)
        x, h = L.apply_residual_norm(x, xattn_out, lp["ln2"], cfg, phase)
        return x + L.apply_mlp(h, lp["mlp"], cfg)

    layer = T.remat_wrap(layer, cfg, phase)
    for i in range(cfg.n_layers):
        x = layer(x, T._layer(params["dec_layers"], i), enc_out)
    x = L.apply_norm(x, params["final_norm"], cfg, phase)
    return L.lm_logits(params["embed"], x, cfg)


def forward(params, batch, cfg: ArchConfig, phase: str) -> torch.Tensor:
    """batch {"frames": (B, S_enc, D), "tokens": (B, S)} -> logits."""
    enc_out = encode(params, batch["frames"], cfg, phase)
    return decode(params, batch["tokens"], enc_out, cfg, phase)


# -- dense-cache serving (the paged path's oracle) ------------------------------


def init_cache(cfg: ArchConfig, batch: int, length: int, device):
    """The decoder's stacked self-attention caches (``transformer``'s
    layout) and every layer's cross K/V (L, B, cross_len, KV, hd) with
    their positions."""
    shape = (cfg.n_layers, batch, cfg.cross_len, cfg.n_kv_heads,
             cfg.head_dim)
    dt = L.torch_dtype(cfg.dtype)
    return {"self": T.init_cache(cfg, batch, length, device),
            "cross_k": torch.zeros(shape, dtype=dt, device=device),
            "cross_v": torch.zeros(shape, dtype=dt, device=device),
            "cross_pos": torch.arange(cfg.cross_len, dtype=torch.int32,
                                      device=device)}


def _cross_context(enc_out, cfg: ArchConfig):
    """The encoder states cut or zero-padded to ``cross_len`` rows, and the
    cross positions (padded rows at 2**30)."""
    enc_ctx = enc_out[:, :cfg.cross_len]
    valid = enc_ctx.shape[1]
    pos = torch.arange(cfg.cross_len, dtype=torch.int32,
                       device=enc_out.device)
    pos = torch.where(pos < valid, pos, NO_KEY).to(torch.int32)
    if valid < cfg.cross_len:
        enc_ctx = F.pad(enc_ctx, (0, 0, 0, cfg.cross_len - valid))
    return enc_ctx, pos


def prefill(params, batch, cfg: ArchConfig, cache_len: int, n_pad=None):
    """Encode the frames and run the decoder prompt, filling the self and
    cross caches: batch {"frames": (B, S_enc, D), "tokens": (B, S)}.
    Returns (last-position logits (B, 1, V), cache)."""
    if n_pad is not None:
        raise ValueError("encdec prefill takes no per-lane padding")
    enc_out = encode(params, batch["frames"], cfg, "serve")
    enc_ctx, cross_pos = _cross_context(enc_out, cfg)
    tokens = batch["tokens"]
    s = tokens.shape[1]
    x = L.embed_tokens(params["embed"], tokens, cfg)
    x = x + L.cast(_sin_pos(s, cfg.d_model, x.device), cfg)[None]
    positions = torch.arange(s, device=x.device)
    dt = L.torch_dtype(cfg.dtype)
    lay = params["dec_layers"]
    ks, vs, cks, cvs = [], [], [], []
    for i in range(cfg.n_layers):
        lp = T._layer(lay, i)
        h = L.apply_norm(x, lp["ln1"], cfg, "serve")
        q, k, v = L._project_qkv(lp["attn"], h, cfg)
        ctx = L.attend_dense(q, k, v, positions, positions, cfg, "serve")
        attn_out = L._wo_proj(ctx, lp["attn"], cfg)
        x, h = L.apply_residual_norm(x, attn_out, lp["ln_x"], cfg, "serve")
        ck, cv = L.cross_kv(lp["xattn"], enc_ctx, cfg)
        xattn_out = L.apply_cross_attention(lp["xattn"], h, (ck, cv), cfg,
                                            "serve", k_pos=cross_pos)
        x, h = L.apply_residual_norm(x, xattn_out, lp["ln2"], cfg, "serve")
        x = x + L.apply_mlp(h, lp["mlp"], cfg)
        kq, vq, pp = L.pack_prefill_cache(k, v, positions, cache_len, cfg)
        ks.append(kq)
        vs.append(vq)
        cks.append(ck.to(dt))
        cvs.append(cv.to(dt))
    x = L.apply_norm(x, params["final_norm"], cfg, "serve")
    logits = L.lm_logits(params["embed"], x[:, -1:], cfg)
    return logits, {"self": {"k": torch.stack(ks), "v": torch.stack(vs),
                             "pos": pp},
                    "cross_k": torch.stack(cks), "cross_v": torch.stack(cvs),
                    "cross_pos": cross_pos}


def decode_step(params, cache, token, pos, cfg: ArchConfig, write_pos=None):
    """One decoder token (B,) at the shared position ``pos`` against the
    dense caches, which are updated in place (the self-attention columns
    after the layer loop, as in ``transformer.decode_step``). Returns
    (logits (B, V), cache)."""
    x = L.embed_tokens(params["embed"], token[:, None], cfg)
    wp = int(pos if write_pos is None else write_pos)
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
    x = x + sin_rows(pos, cfg.d_model)[None, None].to(x.dtype)
    sc = cache["self"]
    sk, sv, cpos = sc["k"], sc["v"], sc["pos"]
    slot = min(wp, sk.shape[-1] - 1)
    cpos[slot] = pos
    lay = params["dec_layers"]
    k_cols, v_rows = [], []
    for i in range(cfg.n_layers):
        lp = T._layer(lay, i)
        h = L.apply_norm(x, lp["ln1"], cfg, "serve")
        attn_out, k_col, v_row = L.decode_attend_stacked(
            lp["attn"], h, sk, sv, cpos, i, pos, cfg, slot)
        x, h = L.apply_residual_norm(x, attn_out, lp["ln_x"], cfg, "serve")
        xattn_out = L.apply_cross_attention(
            lp["xattn"], h, (L.cast(cache["cross_k"][i], cfg),
                             L.cast(cache["cross_v"][i], cfg)),
            cfg, "serve", k_pos=cache["cross_pos"])
        x, h = L.apply_residual_norm(x, xattn_out, lp["ln2"], cfg, "serve")
        x = x + L.apply_mlp(h, lp["mlp"], cfg)
        k_cols.append(k_col)
        v_rows.append(v_row)
    L.write_kv_columns(sk, sv, torch.stack(k_cols), torch.stack(v_rows), slot)
    x = L.apply_norm(x, params["final_norm"], cfg, "serve")
    return L.lm_logits(params["embed"], x, cfg)[:, 0], cache


# -- paged serving: decoder self-KV in pages, cross K/V in private pages --------


def sequence_state_spec(cfg: ArchConfig) -> SequenceStateSpec:
    """Cross pages are per request (the encoder's output), so decoder
    prompts cannot share pages across requests (no prefix cache, no COW
    fork), and speculative verify is dense-family only."""
    return SequenceStateSpec(
        family="encdec", kv_layers=cfg.n_layers, cross_tokens=cfg.cross_len,
        supports_prefix_cache=False, supports_spec_decode=False,
        supports_cow_fork=False, window=0)


def encode_paged(params, frames, cross_table, state, cfg: ArchConfig):
    """Run the encoder and park every decoder layer's cross K/V in the
    request's cross pages, in place: frames (B, S_enc, D), cross_table
    (B, NBc) covering ``cfg.cross_len`` rows. Returns the state."""
    enc_out = encode(params, frames, cfg, "serve")
    enc_ctx, _ = _cross_context(enc_out, cfg)
    pk, pv = state["k"], state["v"]
    positions = torch.broadcast_to(
        torch.arange(cfg.cross_len, device=frames.device)[None],
        (frames.shape[0], cfg.cross_len))
    block_ids, offsets = slots_for_positions(positions, pk.shape[2],
                                             cross_table)
    lay = params["dec_layers"]
    for i in range(cfg.n_layers):
        ck, cv = L.cross_kv(T._layer(lay, i)["xattn"], enc_ctx, cfg)
        write_tokens(pk[i], L.kv_quant(ck, cfg), block_ids, offsets)
        write_tokens(pv[i], L.kv_quant(cv, cfg), block_ids, offsets)
    return state


def _gather_cross(state, refs, cfg: ArchConfig
                  ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Per layer (ck, cv) (B, cross_len, KV, hd) read from the requests'
    cross pages, once per call or decode horizon (the rows are
    read-only). As in the reference the rows are cast, not dequantized."""
    return [(L.cast(gather_kv(state["k"][i], refs["cross"])
                    [:, :cfg.cross_len], cfg),
             L.cast(gather_kv(state["v"][i], refs["cross"])
                    [:, :cfg.cross_len], cfg))
            for i in range(cfg.n_layers)]


def _forward_paged(params, tokens, positions, n_valid, kv_len, refs, state,
                   cfg: ArchConfig, *, causal: bool, cross=None):
    """The decoder for C tokens per lane against paged self-KV (written
    before it is attended, in place; writes past ``n_valid`` go to the
    null page) and page-parked cross K/V (``cross`` pre-gathered, else
    gathered here). Cross rows at or past a lane's ``cross_valid`` are
    masked. Returns (logits (B, C, V), state)."""
    pk, pv = state["k"], state["v"]
    tables = refs["tables"]
    x = L.embed_tokens(params["embed"], tokens, cfg)
    x = x + sin_rows(positions, cfg.d_model).to(x.dtype)
    q_start = positions[:, 0]
    block_ids, offsets = slots_for_positions(positions, pk.shape[2], tables)
    block_ids = torch.where(positions < (q_start + n_valid)[:, None],
                            block_ids, 0)
    cols = torch.arange(cfg.cross_len, device=x.device)[None]
    cross_pos = torch.where(cols < refs["cross_valid"][:, None], cols,
                            NO_KEY)
    if cross is None:
        cross = _gather_cross(state, refs, cfg)
    lay = params["dec_layers"]
    for i in range(cfg.n_layers):
        lp = T._layer(lay, i)
        h = L.apply_norm(x, lp["ln1"], cfg, "serve")
        q, k, v = L._project_qkv(lp["attn"], h, cfg)
        write_tokens(pk[i], L.kv_quant(k, cfg), block_ids, offsets)
        write_tokens(pv[i], L.kv_quant(v, cfg), block_ids, offsets)
        ctx = L.paged_attend(q, pk[i], pv[i], tables, q_start, kv_len, cfg,
                             causal=causal)
        attn_out = L._wo_proj(ctx, lp["attn"], cfg)
        x, h = L.apply_residual_norm(x, attn_out, lp["ln_x"], cfg, "serve")
        xattn_out = L.apply_cross_attention(lp["xattn"], h, cross[i], cfg,
                                            "serve", k_pos=cross_pos)
        x, h = L.apply_residual_norm(x, xattn_out, lp["ln2"], cfg, "serve")
        x = x + L.apply_mlp(h, lp["mlp"], cfg)
    x = L.apply_norm(x, params["final_norm"], cfg, "serve")
    return L.lm_logits(params["embed"], x, cfg), state


def prefill_paged(params, tokens, q_start, n_valid, refs, state,
                  cfg: ArchConfig):
    """One chunked-prefill step over the decoder prompt (the encoder ran
    at admission). Returns (logits (B, C, V), state)."""
    c = tokens.shape[1]
    positions = q_start[:, None] + torch.arange(c, device=tokens.device)
    return _forward_paged(params, tokens, positions, n_valid,
                          q_start + n_valid, refs, state, cfg, causal=True)


def decode_step_paged(params, token, pos, refs, state, cfg: ArchConfig):
    """One decode step: token (B,) at positions (B,). Returns (logits
    (B, V), state)."""
    logits, state = _forward_paged(
        params, token[:, None], pos[:, None], torch.ones_like(pos), pos + 1,
        refs, state, cfg, causal=False)
    return logits[:, 0], state


def decode_horizon_paged(params, token, pos, refs, state, temperature,
                         top_k, seed, counter, eos_ids, cfg: ArchConfig, *,
                         num_steps: int, use_top_k: bool = True,
                         stochastic: bool = True, use_eos: bool = True):
    """``num_steps`` decode steps sampling on the device (the contract of
    ``transformer.decode_horizon_paged``); the cross pages are gathered
    once for the whole horizon. Returns (tokens (B, num_steps), done
    (B, num_steps), state)."""
    cross = _gather_cross(state, refs, cfg)
    toks, done = [], []
    for i in range(num_steps):
        logits, state = _forward_paged(
            params, token[:, None], pos[:, None], torch.ones_like(pos),
            pos + 1, refs, state, cfg, causal=False, cross=cross)
        token = sample_tokens(logits[:, 0], temperature, top_k, seed,
                              counter + i if stochastic else counter,
                              cfg.vocab_size, use_top_k=use_top_k,
                              stochastic=stochastic)
        toks.append(token)
        done.append(eos_hits(token, eos_ids) if use_eos
                    else torch.zeros_like(token, dtype=torch.bool))
        pos = pos + 1
    return torch.stack(toks, 1), torch.stack(done, 1), state
