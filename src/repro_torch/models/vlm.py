"""Qwen2-VL backbone with M-RoPE over (temporal, height, width) position
ids [arXiv:2409.12191], the counterpart of ``repro/models/vlm.py``. The
vision patch frontend is a stub: prefill takes precomputed patch + text
embeddings (B, S, D) and their 3-axis position ids (3, B, S). Text decode
embeds tokens with all three axes at the decode position, which is also
the token's column in the dense cache (the reference's convention: a
prompt's last position ids must be its flat positions for decode to
continue it).

Not paged-servable (:func:`sequence_state_spec`): prefill consumes
embeddings, which cannot be replayed from token ids, and M-RoPE needs
position ids the paged request schema does not carry. Served through
:func:`prefill`/:func:`decode_step` on the dense caches of
``transformer``; every attention goes through ``layers.attend_dense`` or
``layers.decode_attend_stacked`` (E2Softmax on the card in SOLE mode).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.state import SequenceStateSpec


# the dense decoder's weights and stacked dense-slot caches
init = T.init
init_cache = T.init_cache


def forward(params, batch, cfg: ArchConfig, phase: str) -> torch.Tensor:
    """batch {"embeds": (B, S, D), "positions": (3, B, S)} -> logits
    (B, S, padded_vocab) float32."""
    x = L.cast(batch["embeds"], cfg)
    positions3 = batch["positions"]

    def layer(x, lp):
        h = L.apply_norm(x, lp["ln1"], cfg, phase)
        attn_out = L.apply_attention_mrope(lp["attn"], h, positions3, cfg,
                                           phase)
        x, h = L.apply_residual_norm(x, attn_out, lp["ln2"], cfg, phase)
        return x + L.apply_mlp(h, lp["mlp"], cfg)

    layer = T.remat_wrap(layer, cfg, phase)
    for i in range(cfg.n_layers):
        x = layer(x, T._layer(params["layers"], i))
    x = L.apply_norm(x, params["final_norm"], cfg, phase)
    return L.lm_logits(params["embed"], x, cfg)


def sequence_state_spec(cfg: ArchConfig) -> SequenceStateSpec:
    """Not paged-servable: the engines refuse the family with the
    reference's error rather than serve it wrong."""
    return SequenceStateSpec(family="vlm", kv_layers=cfg.n_layers,
                             servable=False, window=cfg.window)


def prefill(params, batch, cfg: ArchConfig, cache_len: int, n_pad=None):
    """The whole multimodal prompt: batch {"embeds": (B, S, D),
    "positions": (3, B, S)}. Returns (last-position logits (B, 1, V),
    cache)."""
    if n_pad is not None:
        raise ValueError("vlm prefill takes no per-lane padding")
    x = L.cast(batch["embeds"], cfg)
    positions3 = batch["positions"]
    flat_pos = torch.arange(x.shape[1], device=x.device)
    lay = params["layers"]
    ks, vs = [], []
    for i in range(cfg.n_layers):
        lp = T._layer(lay, i)
        h = L.apply_norm(x, lp["ln1"], cfg, "serve")
        q, k, v = L._project_qkv(lp["attn"], h, cfg)
        q = L.apply_mrope(q, positions3, cfg)
        k = L.apply_mrope(k, positions3, cfg)
        ctx = L.attend_dense(q, k, v, flat_pos, flat_pos, cfg, "serve")
        attn_out = L._wo_proj(ctx, lp["attn"], cfg)
        x, h = L.apply_residual_norm(x, attn_out, lp["ln2"], cfg, "serve")
        x = x + L.apply_mlp(h, lp["mlp"], cfg)
        kq, vq, pp = L.pack_prefill_cache(k, v, flat_pos, cache_len, cfg)
        ks.append(kq)
        vs.append(vq)
    x = L.apply_norm(x, params["final_norm"], cfg, "serve")
    logits = L.lm_logits(params["embed"], x[:, -1:], cfg)
    return logits, {"k": torch.stack(ks), "v": torch.stack(vs), "pos": pp}


def decode_step(params, cache, token, pos, cfg: ArchConfig, write_pos=None):
    """One text token (B,) at the shared position ``pos`` (all three
    M-RoPE axes), against the dense caches, updated in place. Returns
    (logits (B, V), cache)."""
    x = L.embed_tokens(params["embed"], token[:, None], cfg)
    wp = int(pos if write_pos is None else write_pos)
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
    pos3 = torch.broadcast_to(pos, (3, token.shape[0], 1))
    ck, cv, cpos = cache["k"], cache["v"], cache["pos"]
    slot = min(wp, ck.shape[-1] - 1)
    cpos[slot] = pos
    lay = params["layers"]
    k_cols, v_rows = [], []
    for i in range(cfg.n_layers):
        lp = T._layer(lay, i)
        h = L.apply_norm(x, lp["ln1"], cfg, "serve")
        attn_out, k_col, v_row = L.decode_attend_stacked(
            lp["attn"], h, ck, cv, cpos, i, pos, cfg, slot, positions3=pos3)
        x, h = L.apply_residual_norm(x, attn_out, lp["ln2"], cfg, "serve")
        x = x + L.apply_mlp(h, lp["mlp"], cfg)
        k_cols.append(k_col)
        v_rows.append(v_row)
    L.write_kv_columns(ck, cv, torch.stack(k_cols), torch.stack(v_rows), slot)
    x = L.apply_norm(x, params["final_norm"], cfg, "serve")
    return L.lm_logits(params["embed"], x, cfg)[:, 0], cache
