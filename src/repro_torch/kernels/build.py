"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``kernels/csrc/<name>.cu`` exports a plain C interface (pointers
and the stream as ``void*``, no PyTorch headers), so one source compiles
in seconds::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/repro_torch/<name>-<hash>.so

The library lands in ``build/repro_torch/`` at the repository root (a
directory ``.gitignore`` lists), keyed by a hash of the source and the
flags, on first use. ``--use_fast_math`` is deliberately absent: the
SOLE codes depend on correctly rounded ``/`` and on ``rintf``. A missing
``nvcc`` or a failed build raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NAMES = ("paged_e2softmax", "ailayernorm", "int8_matmul", "e2softmax",
         "flash_e2softmax")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
NVCC_DEFAULT = "/usr/local/cuda/bin/nvcc"

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
# nvcc's -Xptxas -v report (registers, shared memory, spills) per kernel
# source, from the build that produced the loaded library.
BUILD_LOGS: Dict[str, str] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.exists(NVCC_DEFAULT):
        return NVCC_DEFAULT
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the port's CUDA "
        "kernels are compiled from kernels/csrc on the machine with the card")


def library_path(name: str) -> Path:
    """Where the library of ``kernels/csrc/<name>.cu`` is built, keyed by
    the source, the shared headers it may include (``csrc/*.cuh``) and the
    flags."""
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{key[:16]}.so"


def _start(name: str, out: Path) -> subprocess.Popen:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(name: str, out: Path, proc: subprocess.Popen) -> None:
    log, _ = proc.communicate()
    BUILD_LOGS[name] = log
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile every listed source that is not built yet, all ``nvcc``
    processes started together, and load them. Returns the build logs."""
    names = tuple(names or NAMES)
    with _LOCK:
        todo = {n: library_path(n) for n in names if n not in _LIBS}
        procs = {n: _start(n, out) for n, out in todo.items()
                 if not out.exists()}
        try:
            for n, proc in procs.items():
                _finish(n, todo[n], proc)
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        for n, out in todo.items():
            _LIBS[n] = ctypes.CDLL(str(out))
            BUILD_LOGS.setdefault(n, "(cached build)")
    return {n: BUILD_LOGS[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``kernels/csrc/<name>.cu``, built on first
    use."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = _LIBS[name]
    return lib


def launch(device, fn, *args) -> int:
    """Call the C launcher ``fn(*args, stream)`` on ``device``'s current
    stream, with ``device`` the current one (made so only where it is not:
    a context switch costs the host microseconds on every launch); returns
    the launcher's ``cudaError_t``."""
    import torch
    cur = torch.cuda.current_device()
    idx = cur if device.index is None else device.index
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    stream = (raw(idx) if raw is not None
              else torch.cuda.current_stream(idx).cuda_stream)
    if idx == cur:
        return fn(*args, ctypes.c_void_p(stream))
    with torch.cuda.device(idx):
        return fn(*args, ctypes.c_void_p(stream))


def refuse_grad(what: str, *tensors) -> None:
    """Raise where autograd would record a call of a kernel that has no
    backward (grad mode on and an input that requires grad): its output
    would cut the graph silently. Only the exact norm has a backward
    kernel."""
    import torch
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad
            for t in tensors):
        raise RuntimeError(
            f"{what} has no backward kernel: its inputs require grad. "
            "Training runs the exact modes (train_softmax_mode and "
            "train_norm_mode 'exact'); run the plain versions "
            "(ops_backend='reference') to differentiate a SOLE op")


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned after a launch."""
    if rc != 0:
        msg = lib.repro_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


_DECLARED: Dict[tuple, object] = {}


def declare(lib: ctypes.CDLL, fn: str, n_ptrs: int, n_ints: int,
            n_floats: int = 0):
    """Set ``argtypes``/``restype`` of a launcher taking ``n_ptrs``
    pointers, ``n_ints`` ints, ``n_floats`` floats and the stream, in
    that order; returns the function (declared once per library)."""
    key = (lib, fn, n_ptrs, n_ints, n_floats)
    f = _DECLARED.get(key)
    if f is not None:
        return f
    f = getattr(lib, fn)
    f.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                  + [ctypes.c_float] * n_floats + [ctypes.c_void_p])
    f.restype = ctypes.c_int
    err = lib.repro_cuda_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    _DECLARED[key] = f
    return f
