"""Dense decoder-only LM (qwen2 / stablelm backbone): parameter init, the
full-sequence forward, the dense-slot serve path (whole-prompt prefill
into stacked dot-layout caches, one-token decode steps) and the paged
serve path (the paged forward, chunked prefill, decode steps and fused
decode horizons that sample on the device).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.sole.quant import is_qtensor
from repro_torch.models import layers as L
from repro_torch.models.state import SequenceStateSpec
from repro_torch.serve.kv_cache import slots_for_positions, write_tokens
from repro_torch.serve.sampling import eos_hits, sample_tokens


def _normal(gen, shape, scale, dtype, device):
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    # scaled in place: one float32 draw of nemotron_4_15b's MLP is 19 GB
    return w.mul_(scale).to(dtype)


def _norm(cfg: ArchConfig, lead, device):
    shape = tuple(lead) + (cfg.d_model,)
    p = {"g": torch.ones(shape, dtype=torch.float32, device=device)}
    if cfg.norm_kind == "layernorm":
        p["b"] = torch.zeros(shape, dtype=torch.float32, device=device)
    return p


def init(gen: torch.Generator, cfg: ArchConfig, device) -> Dict:
    """Random weights with the reference's shapes and scales (normal x
    0.02; the LM head x d_model^-0.5; norms ones/zeros; QKV biases zero),
    drawn from ``gen`` and stored once in their serving dtype. Per-layer
    leaves carry the stacked leading ``layers`` axis. Under
    ``cfg.quant.weights`` the matmul weights stay float32 masters, as in
    the reference, so the engine packs its int8 codes from float32."""
    dt = L.torch_dtype(cfg.dtype)
    master = torch.float32 if cfg.quant.weights else dt
    d, h, kv, hd, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                       cfg.head_dim, cfg.d_ff)
    n = cfg.n_layers
    v = cfg.padded_vocab

    def w(shape, scale=0.02, dtype=dt):
        return _normal(gen, shape, scale, dtype, device)

    def mw(shape, scale=0.02):     # a matmul weight (QUANT_WEIGHT_SPEC)
        return w(shape, scale, master)

    attn = {"wq": mw((n, d, h, hd)), "wk": mw((n, d, kv, hd)),
            "wv": mw((n, d, kv, hd)), "wo": mw((n, h, hd, d))}
    if cfg.qkv_bias:
        attn["bq"] = torch.zeros((n, h, hd), dtype=dt, device=device)
        attn["bk"] = torch.zeros((n, kv, hd), dtype=dt, device=device)
        attn["bv"] = torch.zeros((n, kv, hd), dtype=dt, device=device)
    if cfg.mlp_kind not in L.MLP_KINDS:
        raise ValueError(f"unknown mlp_kind {cfg.mlp_kind!r}")
    mlp = {"up": mw((n, d, f)), "down": mw((n, f, d))}
    if cfg.mlp_kind in L.GATED_MLP_KINDS:
        mlp = {"gate": mw((n, d, f)), **mlp}
    return {
        "embed": {"table": w((v, d)), "head": mw((d, v), d ** -0.5)},
        "layers": {
            "ln1": _norm(cfg, (n,), device),
            "attn": attn,
            "ln2": _norm(cfg, (n,), device),
            "mlp": mlp,
        },
        "final_norm": _norm(cfg, (), device),
    }


def sequence_state_spec(cfg: ArchConfig) -> SequenceStateSpec:
    """Dense LMs: sequence state is attention KV and nothing else."""
    return SequenceStateSpec(family="dense", kv_layers=cfg.n_layers,
                             supports_prefix_cache=True)


def _layer(tree, i: int):
    """Layer ``i``'s slice (views) of the stacked per-layer params."""
    if isinstance(tree, dict):
        return {k: _layer(t, i) for k, t in tree.items()}
    return tree[i]


def forward(params, tokens, cfg: ArchConfig, phase: str) -> torch.Tensor:
    """tokens (B, S) -> logits (B, S, padded_vocab) float32."""
    x = L.embed_tokens(params["embed"], tokens, cfg)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    lay = params["layers"]
    for i in range(cfg.n_layers):
        lp = _layer(lay, i)
        h = L.apply_norm(x, lp["ln1"], cfg, phase)
        attn_out = L.apply_attention(lp["attn"], h, positions, cfg, phase)
        x, h = L.apply_residual_norm(x, attn_out, lp["ln2"], cfg, phase)
        x = x + L.apply_mlp(h, lp["mlp"], cfg)
    x = L.apply_norm(x, params["final_norm"], cfg, phase)
    return L.lm_logits(params["embed"], x, cfg)


# -- dense-slot serving --------------------------------------------------------


def init_cache(cfg: ArchConfig, batch: int, length: int, device):
    """Stacked dot-layout caches k (L,B,KV,hd,T), v (L,B,KV,T,hd) in the
    KV store dtype and one shared position ring (T,) of 2**30 (empty)."""
    t = min(length, cfg.window) if cfg.window else length
    dt = L.kv_store_dtype(cfg)
    lk = (cfg.n_layers, batch, cfg.n_kv_heads, cfg.head_dim, t)
    lv = (cfg.n_layers, batch, cfg.n_kv_heads, t, cfg.head_dim)
    return {"k": torch.zeros(lk, dtype=dt, device=device),
            "v": torch.zeros(lv, dtype=dt, device=device),
            "pos": torch.full((t,), 2 ** 30, dtype=torch.int32,
                              device=device)}


def prefill(params, tokens, cfg: ArchConfig, cache_len: int,
            n_pad: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Run the whole prompt, returning the last position's logits
    (B, 1, padded_vocab) and the filled cache.

    ``n_pad`` (B,) marks left padding per lane: lane ``j``'s real tokens
    occupy columns ``n_pad[j]..S-1`` at logical positions ``0..``. Pad
    columns are masked out of every key set (stored position 2**30) and
    RoPE sees the local positions; pad rows still take part in every SOLE
    norm's batch-global calibration, as in the reference. ``n_pad=None``
    keeps the shared ``arange(S)`` positions.
    """
    b, s = tokens.shape
    dev = tokens.device
    x = L.embed_tokens(params["embed"], tokens, cfg)
    if n_pad is None:
        q_pos = k_pos = rope_pos = torch.arange(s, device=dev)
    else:
        local = torch.arange(s, device=dev)[None] - n_pad[:, None].long()
        k_pos = torch.where(local < 0, 2 ** 30, local)  # pads: masked keys
        q_pos = rope_pos = torch.clamp_min(local, 0)
    t = min(cache_len, cfg.window) if cfg.window else cache_len
    # the blocked path takes shared positions only: left-padded lanes
    # attend dense
    blocked = n_pad is None and L.attn_impl(cfg, s) == "blocked"
    attend = L.attend_blocked if blocked else L.attend_dense
    lay = params["layers"]
    ks, vs = [], []
    for i in range(cfg.n_layers):
        lp = _layer(lay, i)
        h = L.apply_norm(x, lp["ln1"], cfg, "serve")
        q, k, v = L._project_qkv(lp["attn"], h, cfg)
        if cfg.pos_kind == "rope":
            q = L.apply_rope(q, rope_pos, cfg)
            k = L.apply_rope(k, rope_pos, cfg)
        ctx = attend(q, k, v, q_pos, k_pos, cfg, "serve", causal=cfg.causal)
        attn_out = L._wo_proj(ctx, lp["attn"], cfg)
        x, h = L.apply_residual_norm(x, attn_out, lp["ln2"], cfg, "serve")
        x = x + L.apply_mlp(h, lp["mlp"], cfg)
        kq, vq, pp = L.pack_prefill_cache(k, v, k_pos, t, cfg)
        ks.append(kq)
        vs.append(vq)
    cache = {"k": torch.stack(ks), "v": torch.stack(vs), "pos": pp}
    x = L.apply_norm(x, params["final_norm"], cfg, "serve")
    return L.lm_logits(params["embed"], x[:, -1:], cfg), cache


def decode_step(params, cache, token, pos, cfg: ArchConfig,
                write_pos: Optional[int] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step: token (B,) at ``pos``, a scalar or (B,) per-lane
    logical positions (left-padded batches), with ``write_pos`` the shared
    physical ring column (prompt length + step). Returns (logits
    (B, padded_vocab), cache).

    The cache is updated **in place**: the layers only read it (the
    current token is attended as an extra column), then every layer's new
    column is written at one slot, as the reference does after its layer
    scan.
    """
    x = L.embed_tokens(params["embed"], token[:, None], cfg)
    t = cache["k"].shape[-1]
    wp = int(pos if write_pos is None else write_pos)
    slot = wp % t if cfg.window else min(wp, t - 1)
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
    cpos = cache["pos"]
    if cpos.ndim == 2:                   # per-lane position ring (B, T)
        cpos[:, slot] = torch.broadcast_to(pos, (cpos.shape[0],))
    else:
        cpos[slot] = pos
    ck, cv = cache["k"], cache["v"]
    lay = params["layers"]
    k_cols, v_rows = [], []
    for i in range(cfg.n_layers):
        lp = _layer(lay, i)
        h = L.apply_norm(x, lp["ln1"], cfg, "serve")
        attn_out, k_col, v_row = L.decode_attend_stacked(
            lp["attn"], h, ck, cv, cpos, i, pos, cfg, slot)
        x, h = L.apply_residual_norm(x, attn_out, lp["ln2"], cfg, "serve")
        x = x + L.apply_mlp(h, lp["mlp"], cfg)
        k_cols.append(k_col)
        v_rows.append(v_row)
    L.write_kv_columns(ck, cv, torch.stack(k_cols), torch.stack(v_rows), slot)
    x = L.apply_norm(x, params["final_norm"], cfg, "serve")
    logits = L.lm_logits(params["embed"], x, cfg)
    return logits[:, 0], cache


# -- paged serving --------------------------------------------------------------


def _paged_forward(params, tokens, positions, n_valid, kv_len, tables,
                   pools, cfg: ArchConfig, *, causal: bool):
    """Run C tokens per sequence against the paged pools.

    tokens/positions: (B, C) absolute positions; n_valid: (B,) real
    tokens in this chunk; kv_len: (B,) valid keys after this chunk's
    writes; tables: (B, NB); pools: {"k","v"} (L, N, bs, KV, hd).

    The pools are updated **in place**: each layer scatters the chunk's
    K/V into its pages (through a view of ``pools[..][i]``) before
    attending, so queries see themselves through the page table. Writes
    past ``n_valid`` (the padded tail of a final prefill chunk) go to
    the null page 0. Each residual add is deferred into the consumer
    norm (the MLP output of layer i merges with layer i+1's ln1, the
    last with the final norm), as in the reference. Returns
    (logits (B, C, padded_vocab) float32, pools).

    At w8a8 the residual norms whose consumer is an int8 matmul emit
    ``(int8 codes, per-row scale)`` pairs (ln1 for QKV, ln2 for the MLP,
    the final norm for the head); layer 0's plain norm output is
    quantized on the fly inside the QKV projections.
    """
    lay = params["layers"]
    qact = cfg.quant.acts and is_qtensor(lay["attn"]["wq"])
    quant_ffn = qact and is_qtensor(lay["mlp"]["up"])
    x = L.embed_tokens(params["embed"], tokens, cfg)
    q_start = positions[:, 0]
    pk, pv = pools["k"], pools["v"]
    block_ids, offsets = slots_for_positions(positions, pk.shape[2], tables)
    write_end = (q_start + n_valid)[:, None]
    block_ids = torch.where(positions < write_end, block_ids, 0)
    pending = None                      # deferred MLP residual
    for i in range(cfg.n_layers):
        lp = _layer(lay, i)
        if pending is None:
            h = L.apply_norm(x, lp["ln1"], cfg, "serve")
        else:
            x, h = L.apply_residual_norm(x, pending, lp["ln1"], cfg, "serve",
                                         quant_out=qact)
        q, k, v = L._project_qkv(lp["attn"], h, cfg)
        if cfg.pos_kind == "rope":
            q = L.apply_rope(q, positions, cfg)
            k = L.apply_rope(k, positions, cfg)
        write_tokens(pk[i], L.kv_quant(k, cfg), block_ids, offsets)
        write_tokens(pv[i], L.kv_quant(v, cfg), block_ids, offsets)
        ctx = L.paged_attend(q, pk[i], pv[i], tables, q_start, kv_len, cfg,
                             causal=causal)
        attn_out = L._wo_proj(ctx, lp["attn"], cfg)
        x, h = L.apply_residual_norm(x, attn_out, lp["ln2"], cfg, "serve",
                                     quant_out=quant_ffn)
        pending = L.apply_mlp(h, lp["mlp"], cfg)
    _, x = L.apply_residual_norm(x, pending, params["final_norm"], cfg,
                                 "serve", quant_out=qact)
    return L.lm_logits(params["embed"], x, cfg), pools


def prefill_paged(params, tokens, q_start, n_valid, tables, pools,
                  cfg: ArchConfig):
    """One chunked-prefill step: tokens (B, C) at absolute positions
    q_start..q_start+C-1, of which the first n_valid (B,) are real.
    Returns (logits (B, C, V), pools)."""
    c = tokens.shape[1]
    positions = q_start[:, None] + torch.arange(c, device=tokens.device)
    kv_len = q_start + n_valid
    return _paged_forward(params, tokens, positions, n_valid, kv_len,
                          tables, pools, cfg, causal=True)


def decode_step_paged(params, pools, token, pos, tables, cfg: ArchConfig):
    """One continuous-batching decode step: token (B,) at positions (B,),
    attended with kv_len = pos + 1 and no causal mask. Returns
    (logits (B, V), pools)."""
    logits, pools = _paged_forward(
        params, token[:, None], pos[:, None], torch.ones_like(pos), pos + 1,
        tables, pools, cfg, causal=False)
    return logits[:, 0], pools


def decode_horizon_paged(params, pools, token, pos, tables, temperature,
                         top_k, seed, counter, eos_ids, cfg: ArchConfig, *,
                         num_steps: int, use_top_k: bool = True,
                         stochastic: bool = True, use_eos: bool = True):
    """``num_steps`` decode steps, each sampling its token on the device
    and feeding it to the next, with no host round trip in between. The
    page tables must already cover positions ``pos .. pos + num_steps -
    1``.

    temperature/top_k/seed/counter (B,) are each lane's sampling stream
    (serve/sampling.py): step ``i`` draws with ``counter + i``.
    ``use_top_k``/``stochastic`` skip the rank sort / the Gumbel rows
    when no lane needs them, so an all-greedy batch samples with one
    argmax (and its sampling tensors may be None).

    eos_ids (B, E) is each lane's ``-1``-padded terminator table; a lane
    that samples an eos keeps decoding self-absorbing garbage for the
    rest of the horizon and the host truncates it. Null lanes (all-zero
    table rows) write and read only the null page. Returns (tokens
    (B, num_steps) int32, eos (B, num_steps) bool, pools), on the device.
    """
    toks, done = [], []
    for i in range(num_steps):
        logits, pools = decode_step_paged(params, pools, token, pos, tables,
                                          cfg)
        token = sample_tokens(logits, temperature, top_k, seed,
                              counter + i if stochastic else counter,
                              cfg.vocab_size, use_top_k=use_top_k,
                              stochastic=stochastic)
        toks.append(token)
        done.append(eos_hits(token, eos_ids) if use_eos
                    else torch.zeros_like(token, dtype=torch.bool))
        pos = pos + 1
    return torch.stack(toks, 1), torch.stack(done, 1), pools
