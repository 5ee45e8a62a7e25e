"""Builds the CUDA kernels in ``cxrmate_torch/csrc`` at first use and loads them.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` process, all started
together, for ``sm_90a`` (Hopper); the objects are linked into one shared
library with a plain C interface, loaded with ``ctypes``. The library lives in
``cxrmate_torch/_build/<hash>/``, keyed by a hash of the sources and flags, so a
changed source is rebuilt and an unchanged one is loaded as it is. A file lock
keeps concurrent processes from building the same library twice.

Nothing is built at import: the CPU test box has no ``nvcc``. The first CUDA
launch of a kernel calls :func:`kernel`, which builds if needed.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
LIB_NAME = "libcxrmate_kernels.so"
# -Xptxas -v: each kernel's registers, spills and shared memory go to build.log
COMPILE_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib = None
_fns: Dict[str, ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, PATH, /usr/local/cuda/bin)")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Path of the kernel library, compiling it first if this source hash has
    not been built. Raises with the compiler's output if ``nvcc`` fails."""
    out_dir = BUILD_ROOT / _digest()
    so = out_dir / LIB_NAME
    if so.exists():
        return so
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if so.exists():
            return so
        nvcc = _nvcc()
        cu, _ = _sources()
        procs = []
        for src in cu:
            obj = out_dir / (src.stem + ".o")
            cmd = [nvcc, *COMPILE_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for src, obj, p in procs:
            out, _ = p.communicate()
            logs.append(f"== {src.name} (rc {p.returncode})\n{out}")
            if p.returncode != 0:
                failed.append(src.name)
        (out_dir / "build.log").write_text("\n".join(logs))
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(logs))
        tmp = out_dir / (LIB_NAME + ".tmp")
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp), *[str(o) for _, o, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"linking {LIB_NAME} failed:\n{link.stdout}")
        os.replace(tmp, so)
    return so


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.cxr_error_string.argtypes = [ctypes.c_int]
            lib.cxr_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def kernel(name: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """The C entry ``name`` of the kernel library with its argument types set
    (``c_void_p`` for pointers and the stream). Every entry returns the
    ``cudaError_t`` of its launch."""
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_load(), name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def check(err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = _load().cxr_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: {msg} ({err})")


def stream_of(t: torch.Tensor) -> int:
    """Handle of PyTorch's current stream on ``t``'s device, for a launch."""
    return torch.cuda.current_stream(t.device).cuda_stream


def require(cond: bool, msg) -> None:
    """Reject an argument a kernel does not take. ``msg`` is the message or,
    where building it costs time on every call, a function that builds it."""
    if not cond:
        raise ValueError(msg() if callable(msg) else msg)
