"""Dense decoder-only LM (qwen2 / stablelm / minitron / nemotron / mixtral
backbone): parameter init, the full-sequence forward, the dense-slot serve
path (whole-prompt prefill into stacked dot-layout caches, one-token decode
steps) and the paged serve path (the paged forward, chunked prefill, decode
steps, fused decode horizons that sample on the device, speculative
verify).

MoE archs reuse this module with the FFN swapped (``models/moe.py``): every
entry takes an ``ffn_init`` / ``ffn_apply`` hook, ``ffn_apply(p, h, cfg,
phase)`` in place of :func:`layers.apply_mlp`, as in the reference.

Under mesh rules whose data axis splits a call's lanes
(:func:`layers.data_split`), each serving entry runs this rank's lanes
only, inside :func:`layers.lane_split`: the dense-slot calls and the
serving forward gather their logits over data at the end; the paged
forward gathers each layer's new K/V rows over data before the page
write, so every data rank's pool holds every lane's keys; the decode
horizon and verify sample their lanes and gather the tokens at the end.
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
    if torch.device(device).type == "meta":
        # shapes only (``models.api.param_axes``, the dry run): a meta draw
        # runs torch's Python reference of ``normal_``, whose first call
        # imports the compiler stack (seconds a process)
        return torch.empty(shape, dtype=dtype, device=device)
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    # scaled in place: one float32 draw of nemotron_4_15b's MLP is 19 GB
    return w.mul_(scale).to(dtype)


def stacked(draw, n: int, shape, dtype, device) -> torch.Tensor:
    """(n,) + shape drawn one layer at a time: a float32 draw of a whole
    full-width stack (mixtral's expert gates, rwkv6's channel mix) would
    take gigabytes."""
    out = torch.empty((n,) + tuple(shape), dtype=dtype, device=device)
    for i in range(n):
        out[i] = draw(shape)
    return out


def _norm(cfg: ArchConfig, lead, device):
    shape = tuple(lead) + (cfg.d_model,)
    p = {"g": torch.ones(shape, dtype=torch.float32, device=device)}
    if cfg.norm_kind == "layernorm":
        p["b"] = torch.zeros(shape, dtype=torch.float32, device=device)
    return p


def _weights(gen: torch.Generator, cfg: ArchConfig, device):
    """(w, mw): draw a weight of a shape at a scale in the serving dtype;
    ``mw`` a matmul weight (QUANT_WEIGHT_SPEC), kept as a float32 master
    under ``cfg.quant.weights``."""
    dt = L.torch_dtype(cfg.dtype)
    master = torch.float32 if cfg.quant.weights else dt

    def w(shape, scale=0.02, dtype=dt):
        return _normal(gen, shape, scale, dtype, device)

    def mw(shape, scale=0.02):
        return w(shape, scale, master)
    return w, mw


def init_mlp(gen: torch.Generator, cfg: ArchConfig, device,
             n: Optional[int] = None) -> Dict:
    """The dense FFN's weights stacked over ``n`` layers (``cfg.n_layers``
    by default): gate (gated kinds), up, down."""
    _, mw = _weights(gen, cfg, device)
    n = cfg.n_layers if n is None else n
    d, f = cfg.d_model, cfg.d_ff
    if cfg.mlp_kind not in L.MLP_KINDS:
        raise ValueError(f"unknown mlp_kind {cfg.mlp_kind!r}")
    mlp = {"up": mw((n, d, f)), "down": mw((n, f, d))}
    if cfg.mlp_kind in L.GATED_MLP_KINDS:
        mlp = {"gate": mw((n, d, f)), **mlp}
    return mlp


def init_attention(mw, cfg: ArchConfig, n: int, device) -> Dict:
    """An attention block's projections stacked over ``n`` layers, drawn
    with ``mw`` (:func:`_weights`), and its zero QKV biases if the config
    has them."""
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    attn = {"wq": mw((n, d, h, hd)), "wk": mw((n, d, kv, hd)),
            "wv": mw((n, d, kv, hd)), "wo": mw((n, h, hd, d))}
    if cfg.qkv_bias:
        dt = L.torch_dtype(cfg.dtype)
        attn["bq"] = torch.zeros((n, h, hd), dtype=dt, device=device)
        attn["bk"] = torch.zeros((n, kv, hd), dtype=dt, device=device)
        attn["bv"] = torch.zeros((n, kv, hd), dtype=dt, device=device)
    return attn


def init(gen: torch.Generator, cfg: ArchConfig, device,
         ffn_init=None) -> Dict:
    """Random weights with the reference's shapes and scales (normal x
    0.02; the LM head x d_model^-0.5; norms ones/zeros; QKV biases zero),
    drawn from ``gen`` and stored once in their serving dtype. Per-layer
    leaves carry the stacked leading ``layers`` axis; ``ffn_init(gen,
    cfg, device)`` draws the FFN (:func:`init_mlp` by default). Under
    ``cfg.quant.weights`` the matmul weights stay float32 masters, as in
    the reference, so the engine packs its int8 codes from float32."""
    w, mw = _weights(gen, cfg, device)
    d, n, v = cfg.d_model, cfg.n_layers, cfg.padded_vocab
    attn = init_attention(mw, cfg, n, device)
    mlp = (ffn_init or init_mlp)(gen, cfg, device)
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
                             supports_prefix_cache=True,
                             supports_spec_decode=True,
                             supports_cow_fork=True, window=cfg.window)


def _layer(tree, i: int):
    """Layer ``i``'s slice (views) of the stacked per-layer params."""
    if isinstance(tree, dict):
        return {k: _layer(t, i) for k, t in tree.items()}
    return tree[i]


def _dense_ffn(p, h, cfg: ArchConfig, phase: str,
               stable: bool = False) -> torch.Tensor:
    return L.apply_mlp(h, p, cfg, stable=stable)


def _saves_weight_product(ctx, op, *args, **kwargs):
    """The ``dots`` policy (JAX's ``checkpoint_dots_with_no_batch_dims``):
    keep the outputs of products without batch dimensions — the weight
    products, which reach ATen as ``mm``/``addmm`` or an einsum's ``bmm``
    of batch 1 — and recompute everything else (attention's and the
    experts' batched products, norms, softmax, elementwise)."""
    from torch.utils.checkpoint import CheckpointPolicy
    aten = torch.ops.aten
    if op in (aten.mm.default, aten.addmm.default) or (
            op is aten.bmm.default and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat_wrap(fn, cfg: ArchConfig, phase: str):
    """``cfg.remat`` around one layer's function, as the reference's
    ``remat_wrap`` (``repro/models/transformer.py:18-25``), in a train
    forward that records gradients: ``none`` keeps every activation,
    ``full`` recomputes the layer in the backward pass
    (``torch.utils.checkpoint``, non-reentrant), ``dots`` keeps the weight
    products' outputs and recomputes the rest. Elsewhere (serving, no
    grad) ``fn`` itself: remat changes no value."""
    if (phase != "train" or cfg.remat == "none"
            or not torch.is_grad_enabled()):
        return fn
    if cfg.remat not in ("full", "dots"):
        raise ValueError(f"unknown remat {cfg.remat!r}")
    import functools
    from torch.utils import checkpoint as ckpt
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts,
            _saves_weight_product)

    def wrapped(*args):
        return ckpt.checkpoint(fn, *args, use_reentrant=False, **kw)
    return wrapped


def forward(params, tokens, cfg: ArchConfig, phase: str,
            ffn_apply=None, with_aux: bool = False):
    """tokens (B, S) -> logits (B, S, padded_vocab) float32. With
    ``with_aux`` ``ffn_apply`` returns ``(out, aux)`` and the result is
    ``(logits, sum of the layers' aux)``, summed layer by layer in float32
    from 0, as the reference's scan carry (MoE)."""
    ffn_apply = ffn_apply or _dense_ffn
    # the serving forward (a draft model's) runs this data rank's lanes
    dax = (None if with_aux or phase == "train"
           else L.data_split(tokens.shape[0]))
    with L.lane_split(dax):
        logits = _forward(params, L.lanes(tokens, dax), cfg, phase,
                          ffn_apply, with_aux)
    if dax is None:
        return logits
    return L.gather_lanes(logits, dax)


def _forward(params, tokens, cfg: ArchConfig, phase: str, ffn_apply,
             with_aux: bool):
    x = L.embed_tokens(params["embed"], tokens, cfg)
    positions = torch.arange(tokens.shape[1], device=tokens.device)

    def layer(x, lp):
        h = L.apply_norm(x, lp["ln1"], cfg, phase)
        attn_out = L.apply_attention(lp["attn"], h, positions, cfg, phase)
        x, h = L.apply_residual_norm(x, attn_out, lp["ln2"], cfg, phase)
        out = ffn_apply(lp["mlp"], h, cfg, phase)
        if with_aux:
            return x + out[0], out[1]
        return x + out

    body = remat_wrap(layer, cfg, phase)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device) \
        if with_aux else None
    lay = params["layers"]
    for i in range(cfg.n_layers):
        if with_aux:
            x, a = body(x, _layer(lay, i))
            aux = aux + a
        else:
            x = body(x, _layer(lay, i))
    x = L.apply_norm(x, params["final_norm"], cfg, phase)
    logits = L.lm_logits(params["embed"], x, cfg)
    return (logits, aux) if with_aux else logits


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
            n_pad: Optional[torch.Tensor] = None, ffn_apply=None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Run the whole prompt, returning the last position's logits
    (B, 1, padded_vocab) and the filled cache.

    ``n_pad`` (B,) marks left padding per lane: lane ``j``'s real tokens
    occupy columns ``n_pad[j]..S-1`` at logical positions ``0..``. Pad
    columns are masked out of every key set (stored position 2**30) and
    RoPE sees the local positions; pad rows still take part in every SOLE
    norm's batch-global calibration, as in the reference. ``n_pad=None``
    keeps the shared ``arange(S)`` positions.

    Under rules whose data axis splits the B lanes the rank runs its
    lanes, fills the cache at its shape (its lanes, its KV heads) and
    returns every lane's logits (gathered over data).
    """
    dax = L.data_split(tokens.shape[0])
    with L.lane_split(dax):
        logits, cache = _prefill(params, L.lanes(tokens, dax), cfg,
                                 cache_len, L.lanes(n_pad, dax),
                                 ffn_apply or _dense_ffn)
    return L.gather_lanes(logits, dax), cache


def _prefill(params, tokens, cfg: ArchConfig, cache_len: int, n_pad,
             ffn_apply):
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
        ka, va = L._kv_for_local_heads(k, v, cfg)
        ctx = attend(q, ka, va, q_pos, k_pos, cfg, "serve", causal=cfg.causal)
        attn_out = L._wo_proj(ctx, lp["attn"], cfg)
        x, h = L.apply_residual_norm(x, attn_out, lp["ln2"], cfg, "serve")
        x = x + ffn_apply(lp["mlp"], h, cfg, "serve")
        kq, vq, pp = L.pack_prefill_cache(k, v, k_pos, t, cfg)
        ks.append(kq)
        vs.append(vq)
    cache = {"k": torch.stack(ks), "v": torch.stack(vs), "pos": pp}
    x = L.apply_norm(x, params["final_norm"], cfg, "serve")
    return L.lm_logits(params["embed"], x[:, -1:], cfg), cache


def decode_step(params, cache, token, pos, cfg: ArchConfig,
                write_pos: Optional[int] = None, ffn_apply=None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step: token (B,) at ``pos``, a scalar or (B,) per-lane
    logical positions (left-padded batches), with ``write_pos`` the shared
    physical ring column (prompt length + step). Returns (logits
    (B, padded_vocab), cache).

    The cache is updated **in place**: the layers only read it (the
    current token is attended as an extra column), then every layer's new
    column is written at one slot, as the reference does after its layer
    scan. Under a data split (:func:`prefill`'s) the cache holds this
    rank's lanes, the rank runs them and every lane's logits come back.
    """
    dax = L.data_split(token.shape[0])
    t = cache["k"].shape[-1]
    wp = int(pos if write_pos is None else write_pos)
    slot = wp % t if cfg.window else min(wp, t - 1)
    pos = torch.as_tensor(pos, dtype=torch.int32, device=token.device)
    if pos.ndim:
        pos = L.lanes(pos, dax)
    with L.lane_split(dax):
        logits = _decode_step(params, cache, L.lanes(token, dax), pos, slot,
                              cfg, ffn_apply or _dense_ffn)
    return L.gather_lanes(logits, dax), cache


def _decode_step(params, cache, token, pos, slot: int, cfg: ArchConfig,
                 ffn_apply) -> torch.Tensor:
    x = L.embed_tokens(params["embed"], token[:, None], cfg)
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
        x = x + ffn_apply(lp["mlp"], h, cfg, "serve")
        k_cols.append(k_col)
        v_rows.append(v_row)
    L.write_kv_columns(ck, cv, torch.stack(k_cols), torch.stack(v_rows), slot)
    x = L.apply_norm(x, params["final_norm"], cfg, "serve")
    return L.lm_logits(params["embed"], x, cfg)[:, 0]


# -- paged serving --------------------------------------------------------------


def _paged_forward(params, tokens, positions, n_valid, kv_len, tables,
                   pools, cfg: ArchConfig, *, causal: bool, ffn_apply=None,
                   rows_as_decode: bool = False, stable_rows: bool = False,
                   local_lanes: bool = False):
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
    quantized on the fly inside the QKV projections. A custom
    ``ffn_apply`` (MoE routing) takes float activations, so then the FFN
    input is not quantized, as in the reference. ``rows_as_decode``
    (verify) attends each query row through the decode route
    (:func:`layers.paged_attend`). ``stable_rows`` (a decode or verify
    dispatch) runs, on the card, every float product through the
    row-stable route (:func:`layers.stable_mm`), so a row's logits do not
    depend on how many rows the dispatch carries (``ffn_apply`` takes it as
    ``stable=``).

    Under rules whose data axis splits the B lanes (:func:`layers.data_split`)
    the rank runs its lanes and each layer's new K/V rows are gathered
    over data (one all-gather of the quantized rows) and written for every
    lane, so every data rank's pool stays whole. The logits come back for
    every lane; with ``local_lanes`` ``tokens`` holds this rank's lanes
    only (every other input is the whole batch's) and so do the logits.
    """
    lay = params["layers"]
    qact = cfg.quant.acts and is_qtensor(lay["attn"]["wq"])
    quant_ffn = (qact and ffn_apply is None
                 and is_qtensor(lay["mlp"].get("up")))
    ffn_apply = ffn_apply or _dense_ffn
    stable = stable_rows and tokens.device.type != "cpu"   # the card's route
    pk, pv = pools["k"], pools["v"]
    # every lane's page slots (the gathered K/V rows are written for all)
    block_ids, offsets = slots_for_positions(positions, pk.shape[2], tables)
    write_end = (positions[:, 0] + n_valid)[:, None]
    block_ids = torch.where(positions < write_end, block_ids, 0)
    dax = L.data_split(positions.shape[0])
    if not local_lanes:
        tokens = L.lanes(tokens, dax)
    positions, kv_len, tables = (L.lanes(t, dax)
                                 for t in (positions, kv_len, tables))
    with L.lane_split(dax):
        logits = _paged_layers(params, tokens, positions, kv_len, tables,
                               block_ids, offsets, pk, pv, cfg, dax, causal,
                               ffn_apply, qact, quant_ffn, rows_as_decode,
                               stable)
    if not local_lanes:
        logits = L.gather_lanes(logits, dax)
    return logits, pools


def _paged_layers(params, tokens, positions, kv_len, tables, block_ids,
                  offsets, pk, pv, cfg: ArchConfig, dax, causal: bool,
                  ffn_apply, qact: bool, quant_ffn: bool,
                  rows_as_decode: bool, stable: bool) -> torch.Tensor:
    """:func:`_paged_forward`'s layers on this rank's lanes (``tokens``,
    ``positions``, ``kv_len``, ``tables``); ``block_ids``/``offsets`` every
    lane's page slots. Returns the lanes' logits."""
    lay = params["layers"]
    x = L.embed_tokens(params["embed"], tokens, cfg)
    q_start = positions[:, 0]
    pending = None                      # deferred MLP residual
    for i in range(cfg.n_layers):
        lp = _layer(lay, i)
        if pending is None:
            h = L.apply_norm(x, lp["ln1"], cfg, "serve")
        else:
            x, h = L.apply_residual_norm(x, pending, lp["ln1"], cfg, "serve",
                                         quant_out=qact)
        q, k, v = L._project_qkv(lp["attn"], h, cfg, stable)
        if cfg.pos_kind == "rope":
            q = L.apply_rope(q, positions, cfg)
            k = L.apply_rope(k, positions, cfg)
        kq, vq = L.kv_quant(k, cfg), L.kv_quant(v, cfg)
        if dax is not None:             # every lane's rows reach every pool
            kq, vq = L.gather_lanes(torch.stack([kq, vq]), dax, dim=1)
        write_tokens(pk[i], kq, block_ids, offsets)
        write_tokens(pv[i], vq, block_ids, offsets)
        ctx = L.paged_attend(q, pk[i], pv[i], tables, q_start, kv_len, cfg,
                             causal=causal, rows_as_decode=rows_as_decode)
        attn_out = L._wo_proj(ctx, lp["attn"], cfg, stable)
        x, h = L.apply_residual_norm(x, attn_out, lp["ln2"], cfg, "serve",
                                     quant_out=quant_ffn)
        pending = ffn_apply(lp["mlp"], h, cfg, "serve", stable=stable)
    _, x = L.apply_residual_norm(x, pending, params["final_norm"], cfg,
                                 "serve", quant_out=qact)
    return L.lm_logits(params["embed"], x, cfg, stable)


def prefill_paged(params, tokens, q_start, n_valid, tables, pools,
                  cfg: ArchConfig, *, ffn_apply=None,
                  rows_as_decode: bool = False, local_lanes: bool = False):
    """One chunked-prefill step: tokens (B, C) at absolute positions
    q_start..q_start+C-1, of which the first n_valid (B,) are real.
    Returns (logits (B, C, V), pools). ``rows_as_decode``: attend the rows
    as decode steps, and take the row-stable products (speculative
    verify). ``local_lanes``: under a data split ``tokens`` holds this
    rank's lanes only and so do the logits (the verify dispatch's)."""
    c = tokens.shape[1]
    positions = q_start[:, None] + torch.arange(c, device=tokens.device)
    kv_len = q_start + n_valid
    return _paged_forward(params, tokens, positions, n_valid, kv_len,
                          tables, pools, cfg, causal=True,
                          ffn_apply=ffn_apply, rows_as_decode=rows_as_decode,
                          stable_rows=rows_as_decode, local_lanes=local_lanes)


def decode_step_paged(params, pools, token, pos, tables, cfg: ArchConfig, *,
                      ffn_apply=None, local_lanes: bool = False):
    """One continuous-batching decode step: token (B,) at positions (B,),
    attended with kv_len = pos + 1 and no causal mask, its products
    row-stable (``stable_rows``). Returns (logits (B, V), pools).
    ``local_lanes``: under a data split ``token`` holds this rank's lanes
    only and so do the logits (the decode horizon's feed)."""
    logits, pools = _paged_forward(
        params, token[:, None], pos[:, None], torch.ones_like(pos), pos + 1,
        tables, pools, cfg, causal=False, ffn_apply=ffn_apply,
        stable_rows=True, local_lanes=local_lanes)
    return logits[:, 0], pools


def decode_horizon_paged(params, pools, token, pos, tables, temperature,
                         top_k, seed, counter, eos_ids, cfg: ArchConfig, *,
                         num_steps: int, use_top_k: bool = True,
                         stochastic: bool = True, use_eos: bool = True,
                         ffn_apply=None):
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
    dax = L.data_split(token.shape[0])
    # this data rank's lanes sample and feed their own tokens; every lane's
    # K/V reaches the pools inside each step
    token, temperature, top_k, seed, counter, eos_ids = (
        L.lanes(t, dax) for t in (token, temperature, top_k, seed, counter,
                                  eos_ids))
    toks, done = [], []
    for i in range(num_steps):
        logits, pools = decode_step_paged(params, pools, token, pos, tables,
                                          cfg, ffn_apply=ffn_apply,
                                          local_lanes=True)
        token = sample_tokens(logits, temperature, top_k, seed,
                              counter + i if stochastic else counter,
                              cfg.vocab_size, use_top_k=use_top_k,
                              stochastic=stochastic)
        toks.append(token)
        done.append(eos_hits(token, eos_ids) if use_eos
                    else torch.zeros_like(token, dtype=torch.bool))
        pos = pos + 1
    toks, done = _gather_draws(torch.stack(toks, 1), torch.stack(done, 1),
                               dax)
    return toks, done, pools


def _gather_draws(toks, done, dax):
    """Every lane's (B, W) draws and eos flags from this data rank's, in
    one all-gather over data (as they are where nothing splits)."""
    if dax is None:
        return toks, done
    w = toks.shape[1]
    both = L.gather_lanes(torch.cat([toks.to(torch.int32),
                                     done.to(torch.int32)], 1), dax)
    return both[:, :w], both[:, w:].bool()


def verify_paged(params, pools, tokens, q_start, n_valid, tables,
                 temperature, top_k, seed, counter, eos_ids,
                 cfg: ArchConfig, *, use_top_k: bool = True,
                 stochastic: bool = True, use_eos: bool = True,
                 ffn_apply=None):
    """Speculative verify: score C = K + 1 positions per lane in one
    forward and draw the pinned counter-keyed sample at every position.

    tokens (B, C) is each lane's last kept token followed by its draft
    (zeros past ``n_valid``), fed at positions ``q_start .. q_start + C -
    1`` through the chunked-prefill forward: causal, the draft's K/V
    written to the lane's pre-extended pages, the padded tail routed to
    the null page. Its attention runs the B * C rows as decode rows
    (``rows_as_decode``), so on the card each row has the decode step's
    bits at its position, whatever C. Slot ``i`` draws with counter
    ``counter + i``, so it is the token plain decode would emit there
    given the same prefix (the acceptance rule in serve/spec.py). The sampling tensors follow
    :func:`decode_horizon_paged` (None for an all-greedy batch).

    Returns (pinned (B, C) int32, done (B, C) bool: each draw's
    membership in the lane's ``-1``-padded eos table (B, E), pools), on
    the device; the caller truncates the rejected tails' pages.
    """
    dax = L.data_split(tokens.shape[0])
    logits, pools = prefill_paged(params, L.lanes(tokens, dax), q_start,
                                  n_valid, tables, pools, cfg,
                                  ffn_apply=ffn_apply, rows_as_decode=True,
                                  local_lanes=True)
    b, c = logits.shape[:2]              # this data rank's lanes
    flat = logits.reshape(b * c, logits.shape[-1])
    temperature, top_k, seed, counter, eos_ids = (
        L.lanes(t, dax) for t in (temperature, top_k, seed, counter,
                                  eos_ids))

    def rep(a):                          # (B,) lane values -> (B * C,)
        return None if a is None else torch.repeat_interleave(a, c)
    ctr = None
    if counter is not None:
        ctr = (counter[:, None]
               + torch.arange(c, device=counter.device)).reshape(-1)
    pinned = sample_tokens(flat, rep(temperature), rep(top_k), rep(seed),
                           ctr, cfg.vocab_size, use_top_k=use_top_k,
                           stochastic=stochastic).reshape(b, c)
    done = (eos_hits(pinned, eos_ids[:, None, :]) if use_eos
            else torch.zeros_like(pinned, dtype=torch.bool))
    pinned, done = _gather_draws(pinned, done, dax)
    return pinned, done, pools
