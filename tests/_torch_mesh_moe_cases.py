"""Rank functions of the port's MoE mesh tests
(``tests/test_torch_mesh_moe.py``).

``repro_torch.launch.mesh.spawn`` runs :func:`battery` in fresh gloo ranks,
one CPU thread each, so this module imports no JAX: the weights come in as
the JAX ``init_params`` draw's numpy leaves and are converted in each rank
(``params_from_jax``). The configs are ``mixtral_8x7b.smoke()`` and
``dbrx_132b.smoke()`` (4 experts, top-2, d_ff 128): on a (2, M) mesh each
data rank holds 2 experts, on (·, 2) each model rank 64 of every expert's
``d_ff`` columns.
"""
import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import QuantConfig, get_config
from repro_torch.convert import params_from_jax, shard_params
from repro_torch.launch.mesh import make_mesh, make_rules
from repro_torch.models import api
from repro_torch.models import layers as L
from repro_torch.models import moe as TM
from repro_torch.serve.engine import Engine, PagedEngine
from repro_torch.serve.spec import NGramDrafter, SpecConfig
from repro_torch.sharding import comm
from repro_torch.sharding.rules import use_rules
from tests import _torch_mesh_cases as C

ARCHS = ("mixtral_8x7b", "dbrx_132b")
MODES = ("exact", "sole")
# the op-level cases: (lanes, tokens a lane); 4 lanes split over a data
# axis of 2 (route (a)), one lane of 8 tokens replicates (route (b))
SPLIT_X = (4, 3)
WHOLE_X = (1, 8)
REFUSED = ("rwkv6_7b", "recurrentgemma_9b", "whisper_small", "qwen2_vl_7b")


def cfg_of(arch, mode):
    cfg = get_config(arch).smoke()
    return dataclasses.replace(cfg, **C.EXACT) if mode == "exact" else cfg


def ffn_inputs(arch, shape, seed=0):
    """Seeded float32 activations (B, S, d) for the op-level cases."""
    d = get_config(arch).smoke().d_model
    return np.random.default_rng(seed).standard_normal(
        shape + (d,)).astype(np.float32)


def layer0_mlp(np_params):
    """Layer 0's MoE weights of a numpy tree (the op-level cases')."""
    return {k: v[0] for k, v in np_params["layers"]["mlp"].items()}


def ffn_out(cfg, mlp, x, rules, capacity):
    """The FFN of ``x`` (B, S, d) on this rank under ``rules``: the rank's
    experts (``mlp`` cut by ``convert.shard_params``), its lanes where the
    data axis splits them, every lane's rows back (one all-gather).
    ``capacity``: ``"paged"`` (``moe._paged_ffn``'s, the dispatch's token
    count) or None (the capacity-factor formula on the rank's tokens)."""
    axes = {k: v[1:] for k, v in api.param_axes(cfg)["layers"]["mlp"].items()}
    mine = shard_params(mlp, axes, rules, torch.distributed.get_rank())
    with use_rules(rules):
        dax = L.data_split(x.shape[0])
        with L.lane_split(dax):
            xl = L.lanes(x, dax)
            if capacity == "paged":
                out = TM._paged_ffn(mine, xl, cfg, "serve")
            else:
                out = TM.apply_moe_ffn(mine, xl, cfg, "serve")[0]
        return L.gather_lanes(out, dax).numpy()


def counted(fn):
    """``fn()``'s result and the collectives it ran (``comm.COUNTS``)."""
    before = dict(comm.COUNTS)
    out = fn()
    return out, {k: comm.COUNTS[k] - before.get(k, 0) for k in comm.COUNTS
                 if comm.COUNTS[k] > before.get(k, 0)}


def exchange(ax):
    """:func:`comm.all_to_all` of float32, int32 and bf16 (as its bytes)
    chunks tagged with (source rank, destination chunk): what this rank
    received, as numpy, and the calls counted under ``data.all_to_all``."""
    out = {}
    before = comm.COUNTS["data.all_to_all"]
    for dt in (torch.float32, torch.int32, torch.bfloat16):
        src = (100 * ax.index + torch.arange(ax.size)[:, None] * 10
               + torch.arange(3)[None]).to(dt)
        got = comm.all_to_all(src, ax)
        assert got.dtype == dt and got.shape == src.shape
        out[str(dt)] = got.float().numpy()
    out["counted"] = comm.COUNTS["data.all_to_all"] - before
    return out


def battery(rank, world, shape, np_params, jobs):
    """``shape``'s MoE cases on this rank: the FFN at op level
    (``"ffn"``), the paged engine's traces of each config and mode
    (``"paged"``), the dense-slot ``Engine`` (``"dense"``), an n-gram spec
    trace beside plain decode (``"spec"``), what raises under rules
    (``"refusals"``) and the all_to_all exchange (``"all_to_all"``), as
    ``jobs`` asks. ``np_params``: each config's numpy weights."""
    rules = make_rules(make_mesh(shape, ("data", "model")))
    out = {"data_index": rules.mesh.coordinate("data")}
    if "all_to_all" in jobs:
        out["all_to_all"] = exchange(comm.data_axis(rules))
    if "ffn" in jobs:
        for arch in ARCHS:
            cfg = cfg_of(arch, "exact")
            mlp = params_from_jax({"layers": {"mlp": layer0_mlp(
                np_params[arch])}}, cfg, "cpu")["layers"]["mlp"]
            for xs in (SPLIT_X, WHOLE_X):
                x = torch.from_numpy(ffn_inputs(arch, xs))
                for cap in ("paged", None):
                    out[("ffn", arch, xs, cap)] = counted(
                        lambda: ffn_out(cfg, mlp, x, rules, cap))
    for arch in ARCHS:
        for mode in MODES:
            cfg = cfg_of(arch, mode)
            params = params_from_jax(np_params[arch], cfg, "cpu")
            greedy, sampled = C.requests(cfg)
            if "paged" in jobs:
                eng = PagedEngine(cfg, params, device="cpu", rules=rules,
                                  **C.ENGINE_KW)
                toks = eng.generate(C.reqs(greedy))
                toks += eng.generate(C.reqs(sampled))
                eng.cache.check_refcounts()
                out[("paged", arch, mode)] = dict(
                    tokens=toks, decode_step=decode_counts(eng, cfg, rules))
            if "dense" in jobs and mode == "exact":
                dg, ds = C.dense_requests(cfg)
                eng = Engine(cfg, params, device="cpu", rules=rules,
                             **C.DENSE_KW)
                out[("dense", arch)] = (eng.generate(C.reqs(dg))
                                        + eng.generate(C.reqs(ds)))
            if "spec" in jobs and mode == "exact":
                specs = C.reqs(C.spec_requests(cfg))
                kw = dict(C.ENGINE_KW, decode_horizon=8)
                plain = PagedEngine(cfg, params, device="cpu", rules=rules,
                                    **kw).generate(specs)
                eng = PagedEngine(cfg, params, device="cpu", rules=rules,
                                  spec_config=SpecConfig(NGramDrafter(),
                                                         max_k=4), **kw)
                toks = eng.generate(C.reqs(C.spec_requests(cfg)))
                eng.cache.check_refcounts()
                out[("spec", arch)] = dict(plain=plain, spec=toks,
                                           stats=eng.stats())
    if "refusals" in jobs:
        out["refusals"] = refusals(rules)
    return out


def decode_counts(eng, cfg, rules):
    """The collectives of one MoE decode step of ``decode_batch`` null
    lanes through ``eng``'s weights and pools (``_torch_mesh_cases``'s
    dense step, through the MoE model)."""
    b = eng.decode_batch
    zeros = torch.zeros((b,), dtype=torch.int32)

    def step():
        with use_rules(rules):
            TM.decode_horizon_paged(
                eng.params, eng.cache.pools, zeros, zeros,
                torch.zeros((b, 8), dtype=torch.int32), None, None, None,
                zeros, torch.full((b, 1), -1, dtype=torch.int32), cfg,
                num_steps=1, use_top_k=False, stochastic=False,
                use_eos=False)
    return counted(step)[1]


def refusals(rules):
    """What still raises under ``rules`` inside a group of the mesh's
    ranks: MoE with W8A8 (either engine) and the families of ROADMAP item
    9.2b. Each case's exception type and message, or None where it
    served."""
    def attempt(fn):
        try:
            fn()
        except (NotImplementedError, ValueError) as e:
            return type(e).__name__, str(e)
        return None
    cfg = dataclasses.replace(cfg_of(ARCHS[0], "sole"),
                              quant=QuantConfig("w8a8"))
    params = api.init_params(0, dataclasses.replace(cfg, dtype="float32"),
                             "cpu")
    out = {"paged_w8a8": attempt(lambda: PagedEngine(
        cfg, params, device="cpu", rules=rules, **C.ENGINE_KW)),
        "dense_w8a8": attempt(lambda: Engine(
            cfg, params, device="cpu", rules=rules, **C.DENSE_KW))}
    for arch in REFUSED:
        out[arch] = attempt(lambda: PagedEngine(
            get_config(arch).smoke(), {}, device="cpu", rules=rules))
    return out
