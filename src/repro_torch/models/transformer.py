"""Dense decoder-only LM (qwen2 / stablelm backbone) on the paged serve
path: parameter init, the paged forward, chunked prefill, decode steps
and fused greedy decode horizons.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.sole.quant import is_qtensor
from repro_torch.models import layers as L
from repro_torch.models.state import SequenceStateSpec
from repro_torch.serve.kv_cache import slots_for_positions, write_tokens
from repro_torch.serve.sampling import eos_hits, greedy_tokens


def _normal(gen, shape, scale, dtype, device):
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w * scale).to(dtype)


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
    if cfg.mlp_kind != "swiglu":
        raise NotImplementedError(f"mlp_kind {cfg.mlp_kind!r} is not ported")
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
    return {
        "embed": {"table": w((v, d)), "head": mw((d, v), d ** -0.5)},
        "layers": {
            "ln1": _norm(cfg, (n,), device),
            "attn": attn,
            "ln2": _norm(cfg, (n,), device),
            "mlp": {"gate": mw((n, d, f)), "up": mw((n, d, f)),
                    "down": mw((n, f, d))},
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


def decode_horizon_paged(params, pools, token, pos, tables, eos_ids,
                         cfg: ArchConfig, *, num_steps: int,
                         use_eos: bool = True):
    """``num_steps`` greedy decode steps, each feeding its argmax token
    to the next, with no host round trip in between. The page tables
    must already cover positions ``pos .. pos + num_steps - 1``.

    eos_ids (B, E) is each lane's ``-1``-padded terminator table; a lane
    that samples an eos keeps decoding self-absorbing garbage for the
    rest of the horizon and the host truncates it. Null lanes (all-zero
    table rows) write and read only the null page. Returns (tokens
    (B, num_steps) int32, eos (B, num_steps) bool, pools), on the device.
    """
    toks, done = [], []
    for _ in range(num_steps):
        logits, pools = decode_step_paged(params, pools, token, pos, tables,
                                          cfg)
        token = greedy_tokens(logits, cfg.vocab_size)
        toks.append(token)
        done.append(eos_hits(token, eos_ids) if use_eos
                    else torch.zeros_like(token, dtype=torch.bool))
        pos = pos + 1
    return torch.stack(toks, 1), torch.stack(done, 1), pools
