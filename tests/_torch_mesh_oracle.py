"""The JAX single-device engine the port's mesh tests are held to
(``tests/test_sharded_serve.py``'s ``oracle``: ``rules=None``, the Pallas
kernels in interpret mode), on ``tests/_torch_mesh_cases.py``'s traces."""
import dataclasses

import jax
import numpy as np

from repro.configs.base import QuantConfig
from repro.configs.base import get_config
from repro.models import api
from repro.serve.engine import PagedEngine, Request
from tests import _torch_mesh_cases as C


def exact_cfg():
    return dataclasses.replace(get_config("qwen2_0_5b").smoke(), **C.EXACT)


def params(cfg):
    return api.init_params(jax.random.PRNGKey(0), cfg)[0]


def numpy_params(p):
    """The weights as numpy leaves, for the spawned ranks."""
    return jax.tree.map(np.asarray, p)


def tokens(cfg, p, specs, **kw):
    eng = PagedEngine(cfg, p, backend="pallas", **dict(C.ENGINE_KW, **kw))
    out = eng.generate([Request(**r) for r in specs])
    eng.cache.check_refcounts()
    return out


def w8a8_cfg(cfg):
    return dataclasses.replace(cfg, quant=QuantConfig(mode="w8a8"),
                               kv_cache_dtype="int8")
