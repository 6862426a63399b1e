"""Meshes of ``torch.distributed`` ranks, and the spawner that runs a
function on each rank of one.

:func:`make_mesh` lays the job's ranks out as a (data, model) mesh over
``torch.distributed.device_mesh.init_device_mesh``: rank ``r`` sits at
``unravel_index(r, shape)``, as ``jax.make_mesh`` lays devices out. The
backend is chosen where the process group starts (:func:`pick_backend`,
used by :func:`spawn` and ``launch/serve.py``): ``nccl`` when every rank
has a card of its own, ``gloo`` on the CPU. Ranks that share a card must
ask for ``gloo`` themselves; fewer cards than ranks without that request
raise, as does ``nccl`` asked for without a card per rank.

:func:`spawn` starts ``world`` processes, joins them into one group
(``tcp://localhost`` on a free port, a timeout on every collective) and
returns each rank's result; one overall timeout ends them all, so a hung
collective fails its caller instead of hanging it.
"""
from __future__ import annotations

import datetime
import math
import os
import queue as queue_mod
import socket
import time
import traceback
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.sharding.rules import Rules


class Mesh:
    """A mesh of this job's ranks: ``axis_names``, ``devices`` (each
    position's global rank, an array of the mesh's shape) and, once the
    process group is up, the ``DeviceMesh`` whose per-axis groups the
    collectives run over. Without one it still gives specs (``Rules``
    reads only the names and the shape)."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 device_mesh=None):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {tuple(shape)} and axes "
                             f"{tuple(axis_names)} differ in length")
        self.axis_names = tuple(axis_names)
        self.devices = np.arange(math.prod(shape)).reshape(tuple(shape))
        self.device_mesh = device_mesh

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.devices.shape))

    def coords(self, rank: int) -> dict:
        """``rank``'s index along each axis."""
        idx = np.unravel_index(rank, self.devices.shape)
        return {a: int(i) for a, i in zip(self.axis_names, idx)}

    def coordinate(self, axis: str, rank: Optional[int] = None) -> int:
        """This process's (or ``rank``'s) index along ``axis``."""
        return self.coords(dist.get_rank() if rank is None else rank)[axis]

    def group(self, axis: str):
        """The process group of the ranks that differ only along
        ``axis``, this process's among them."""
        if self.device_mesh is None:
            raise RuntimeError("this mesh has no process group "
                               "(make_mesh builds one)")
        return self.device_mesh.get_group(axis)

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"


def pick_backend(world: int, device, backend: Optional[str] = None) -> str:
    """The process group's backend for ``world`` ranks on ``device``:
    ``gloo`` on the CPU; on CUDA ``nccl`` with a card per rank, ``gloo``
    only when asked for (ranks sharing a card); anything else raises."""
    dev = torch.device(device)
    if dev.type == "cpu":
        if backend not in (None, "gloo"):
            raise ValueError(f"backend {backend!r} on the CPU: only gloo "
                             "runs CPU ranks")
        return "gloo"
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if backend == "gloo":
        return "gloo"
    if backend not in (None, "nccl"):
        raise ValueError(f"unknown backend {backend!r}")
    if cards < world:
        raise RuntimeError(
            f"{world} ranks on {cards} CUDA card(s): nccl needs a card per "
            "rank; to share a card between ranks ask for backend='gloo' "
            "(--dist-backend gloo)")
    return "nccl"


def rank_device(device, backend: str, rank: int) -> torch.device:
    """The device a rank computes on: its own card under nccl (``cuda:<local
    rank>``), the one asked for otherwise."""
    dev = torch.device(device)
    if dev.type == "cuda" and backend == "nccl":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...]) -> Mesh:
    """The mesh of this job's ranks (the default process group must be up
    and hold ``prod(shape)`` ranks)."""
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: torch.distributed is not "
                           "initialized (spawn() or torchrun start it)")
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"mesh {tuple(shape)} needs {math.prod(shape)} "
                         f"ranks, the group has {world}")
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    dm = init_device_mesh(kind, tuple(shape), mesh_dim_names=tuple(axes))
    return Mesh(shape, axes, dm)


def make_rules(mesh, table: Optional[dict] = None) -> Rules:
    return Rules(mesh, table)


def smoke_mesh(data: int = 2, model: int = 2) -> Mesh:
    """A small (data, model) mesh of this job's ranks, cut to the world
    size as ``repro.launch.mesh.smoke_mesh`` cuts it to the devices."""
    n = dist.get_world_size()
    data = min(data, max(n // model, 1))
    if data * model > n:
        model = n // data
    return make_mesh((data, model), ("data", "model"))


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_group(rank: int, world: int, port: int, backend: str,
               timeout: float) -> None:
    """Join the default process group at ``tcp://localhost:<port>``."""
    dist.init_process_group(
        backend, init_method=f"tcp://localhost:{port}", world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=timeout))


def _rank_main(fn, rank, world, port, backend, collective_timeout, threads,
               args, results) -> None:
    try:
        if threads:
            torch.set_num_threads(threads)
        init_group(rank, world, port, backend, collective_timeout)
        if backend == "nccl":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        out = fn(rank, world, *args)
        results.put((rank, True, out))
    except Exception:
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, world: int, args: tuple = (), *,
          backend: str = "gloo", timeout: float = 600.0,
          collective_timeout: float = 120.0, threads: int = 1) -> List:
    """``fn(rank, world, *args)`` in ``world`` fresh processes joined into
    one process group; returns their results in rank order. ``fn`` must
    be importable by name (a module-level function) and its result
    picklable. A rank that raises fails the call with its traceback; past
    ``timeout`` seconds every rank is killed and ``TimeoutError`` raised.
    ``threads``: ``torch.set_num_threads`` in each rank (0 leaves it)."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, port, backend,
                               collective_timeout, threads, args, results),
                         daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    out: dict = {}
    deadline = time.monotonic() + timeout
    try:
        while len(out) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"spawn: {world - len(out)} of {world} ranks unfinished "
                    f"after {timeout:.0f} s")
            try:
                rank, ok, val = results.get(timeout=min(left, 5.0))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in out]
                if dead:
                    raise RuntimeError(f"spawn: rank(s) {dead} died "
                                       "without a result") from None
                continue
            if not ok:
                raise RuntimeError(f"spawn: rank {rank} failed:\n{val}")
            out[rank] = val
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
    return [out[r] for r in range(world)]


def world_from_env() -> Optional[Tuple[int, int]]:
    """(rank, world) when ``torchrun`` started this process
    (``WORLD_SIZE`` and ``RANK`` set), else None."""
    if "WORLD_SIZE" not in os.environ:
        return None
    return int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
