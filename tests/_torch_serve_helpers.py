"""Shared set-up of the serve-feature parity tests (speculative decoding,
the streaming loop, finish events): the same smoke weights, engine
arguments and requests for the JAX package's engines and the port's.

JAX engines run their Pallas kernels as the JAX tests do on the CPU
(``backend="pallas"``, interpret mode); the port's run on the CPU, where
every op takes its kernel's plain version. Weights are the JAX
``init_params`` draw converted through numpy (``params_from_jax``).
"""
import dataclasses
from typing import NamedTuple

import jax
import numpy as np

from repro.configs.base import get_config as jax_config
from repro.models import api as japi
from repro.serve.engine import PagedEngine as JaxEngine
from repro.serve.engine import Request as JaxRequest
from repro_torch.configs.base import get_config
from repro_torch.convert import params_from_jax
from repro_torch.serve.engine import PagedEngine, Request

# the reference serve tests' engine: 40 pages of 8 tokens, 4 lanes
ENGINE_KW = dict(num_blocks=40, block_size=8, max_seq_len=64, max_running=4,
                 decode_batch=4, prefill_chunk=8)
EXACT = dict(softmax_mode="exact", norm_mode="exact", logit_int8=False)


class Pair(NamedTuple):
    """One model on both sides: configs and the same weights."""
    jcfg: object
    tcfg: object
    jparams: object
    tparams: object


def smoke_pair(arch: str = "qwen2_0_5b", modes=EXACT, **change) -> Pair:
    """``arch``'s smoke config (with ``change``, then ``modes``) on both
    sides, weights from ``init_params(0)``."""
    jcfg = dataclasses.replace(jax_config(arch).smoke(), **change)
    tcfg = dataclasses.replace(get_config(arch).smoke(), **change)
    jparams = japi.init_params(0, jcfg)[0]
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    return Pair(dataclasses.replace(jcfg, **modes),
                dataclasses.replace(tcfg, **modes), jparams, tparams)


def jax_engine(pair: Pair, **kw):
    return JaxEngine(pair.jcfg, pair.jparams, backend="pallas",
                     **dict(ENGINE_KW, **kw))


def torch_engine(pair: Pair, **kw):
    return PagedEngine(pair.tcfg, pair.tparams, device="cpu",
                       **dict(ENGINE_KW, **kw))


def specs(vocab, n, rng, plen=16, new=8, **kw):
    """``n`` request specs (keyword dicts) with seeded random prompts."""
    return [dict(prompt=rng.integers(0, vocab, size=plen).astype(np.int32),
                 max_new_tokens=new, **kw) for _ in range(n)]


def as_requests(spec_list):
    """(JAX requests, port requests) of the same specs."""
    return ([JaxRequest(**s) for s in spec_list],
            [Request(**s) for s in spec_list])


def common_stats(jstats, tstats):
    """The stats keys both engines report, with the values of each."""
    keys = sorted(set(jstats) & set(tstats))
    return ({k: jstats[k] for k in keys}, {k: tstats[k] for k in keys})


class OracleDrafter:
    """Proposes the true continuation, read off a plain run's outputs by
    sequence id: every draft is accepted (duck-typed for both sides)."""

    def __init__(self, outs):
        self._outs = outs

    def propose(self, lanes, ks):
        return [self._outs[s.seq_id][len(s.out):len(s.out) + k]
                for s, k in zip(lanes, ks)]


class AntiOracleDrafter(OracleDrafter):
    """The true next tokens shifted by one mod the vocabulary: every draft
    is rejected."""

    def __init__(self, outs, vocab_size):
        super().__init__(outs)
        self._vocab = vocab_size

    def propose(self, lanes, ks):
        return [[(t + 1) % self._vocab for t in d]
                for d in super().propose(lanes, ks)]
