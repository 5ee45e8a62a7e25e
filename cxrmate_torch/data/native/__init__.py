"""The port's JPEG codec and Pillow-exact resampling (``jpeg.cpp``), by ctypes.

The port depends on neither PIL nor libjpeg, so it carries its own baseline
decoder, whose output equals libjpeg(-turbo)'s defaults (and so PIL's) byte
for byte, a baseline encoder with libjpeg's defaults, and Pillow's bilinear
resize and nearest affine transform.

``jpeg.cpp`` is built at first use by the host C++ compiler (``$CXX``,
``g++`` or ``c++``) into ``cxrmate_torch/_build/jpeg-<hash>/``, keyed by a hash of
the source and flags, under a file lock, as ``ops/_build.py`` builds the
kernels; it is a library of its own, so the CPU builds and runs it too. No
compiler raises. A JPEG outside the decoder's set raises ``ValueError``
naming the file and the feature; nothing falls back to another decoder.
The calls are plain ctypes calls, which release the GIL, so a loader's
thread pool decodes in parallel.
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
from typing import Sequence

import numpy as np

SOURCE = Path(__file__).resolve().parent / "jpeg.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "_build"
LIB_NAME = "libcxrmate_jpeg.so"
# no FMA contraction: the resampling's double arithmetic must round as Pillow's does
COMPILE_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off")

_lock = threading.Lock()
_lib = None
_ERR = 512


def _cxx() -> str:
    for c in (os.environ.get("CXX"), shutil.which("g++"), shutil.which("c++")):
        if c and (os.path.exists(c) or shutil.which(c)):
            return c
    raise RuntimeError("no C++ compiler for the JPEG codec (looked for $CXX, g++, c++)")


def build() -> Path:
    """Path of the codec library, compiling it first if this source hash has
    not been built. Raises with the compiler's output if it fails."""
    h = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    out_dir = BUILD_ROOT / ("jpeg-" + h.hexdigest()[:16])
    so = out_dir / LIB_NAME
    if so.exists():
        return so
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if so.exists():
            return so
        tmp = out_dir / (LIB_NAME + ".tmp")
        res = subprocess.run([_cxx(), *COMPILE_FLAGS, str(SOURCE), "-o", str(tmp)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"building {SOURCE.name} failed:\n{res.stdout}")
        os.replace(tmp, so)
    return so


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i, sz, s = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t, ctypes.c_char_p
            ip = ctypes.POINTER(ctypes.c_int)
            for name, args in (
                ("cxr_jpeg_info", [p, sz, ip, ip, ip, s, i]),
                ("cxr_jpeg_decode", [p, sz, p, s, i]),
                ("cxr_jpeg_encode", [p, i, i, i, i, i, ctypes.POINTER(p),
                                     ctypes.POINTER(sz), s, i]),
                ("cxr_resize_bilinear", [p, i, i, i, p, i, i, s, i]),
            ):
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = args, ctypes.c_int
            lib.cxr_free.argtypes, lib.cxr_free.restype = [p], None
            lib.cxr_affine_nearest.argtypes = [p, i, i, i, p, p]
            lib.cxr_affine_nearest.restype = None
            _lib = lib
    return _lib


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def decode(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """JPEG bytes -> uint8 [H, W] (one component) or [H, W, 3] (RGB), the
    pixels PIL's ``np.asarray(Image.open(...))`` gives. Raises ``ValueError``
    naming ``name`` and what is not supported."""
    lib = _load()
    buf = np.frombuffer(data, np.uint8)
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = ctypes.create_string_buffer(_ERR)
    if lib.cxr_jpeg_info(_ptr(buf), buf.size, ctypes.byref(w), ctypes.byref(h), ctypes.byref(c),
                         err, _ERR):
        raise ValueError(f"{name}: {err.value.decode()}")
    shape = (h.value, w.value) if c.value == 1 else (h.value, w.value, 3)
    out = np.empty(shape, np.uint8)
    if lib.cxr_jpeg_decode(_ptr(buf), buf.size, _ptr(out), err, _ERR):
        raise ValueError(f"{name}: {err.value.decode()}")
    return out


def load_jpeg(path: str) -> np.ndarray:
    """Read and decode the JPEG file at ``path`` (see :func:`decode`)."""
    with open(path, "rb") as f:
        return decode(f.read(), path)


def encode(pixels: np.ndarray, quality: int = 75, restart_interval: int = 0) -> bytes:
    """uint8 [H, W] (gray) or [H, W, 3] (RGB, written as YCbCr 4:2:0) -> baseline
    JPEG bytes with libjpeg's default tables at ``quality``, and a DRI
    restart marker every ``restart_interval`` MCUs when it is not 0."""
    px = np.ascontiguousarray(pixels, dtype=np.uint8)
    if px.ndim not in (2, 3) or (px.ndim == 3 and px.shape[2] != 3):
        raise ValueError(f"encode takes [H, W] or [H, W, 3] uint8, got {pixels.shape}")
    lib = _load()
    out, n = ctypes.c_void_p(), ctypes.c_size_t()
    err = ctypes.create_string_buffer(_ERR)
    if lib.cxr_jpeg_encode(_ptr(px), px.shape[1], px.shape[0], 1 if px.ndim == 2 else 3,
                           int(quality), int(restart_interval), ctypes.byref(out),
                           ctypes.byref(n), err, _ERR):
        raise ValueError(f"JPEG encode failed: {err.value.decode()}")
    try:
        return ctypes.string_at(out.value, n.value)
    finally:
        lib.cxr_free(out)


def save_jpeg(path: str, pixels: np.ndarray, quality: int = 75, restart_interval: int = 0) -> None:
    with open(path, "wb") as f:
        f.write(encode(pixels, quality, restart_interval))


def resize_bilinear(arr: np.ndarray, size: Sequence[int]) -> np.ndarray:
    """Pillow's ``Image.resize((w, h), BILINEAR)`` of a uint8 [H, W] or
    [H, W, C] array, bit for bit."""
    src = np.ascontiguousarray(arr, dtype=np.uint8)
    ow, oh = int(size[0]), int(size[1])
    ch = 1 if src.ndim == 2 else src.shape[2]
    out = np.empty((oh, ow) if src.ndim == 2 else (oh, ow, ch), np.uint8)
    err = ctypes.create_string_buffer(_ERR)
    if _load().cxr_resize_bilinear(_ptr(src), src.shape[1], src.shape[0], ch, _ptr(out), ow, oh,
                                   err, _ERR):
        raise ValueError(f"resize failed: {err.value.decode()}")
    return out


def affine_nearest(arr: np.ndarray, matrix: Sequence[float]) -> np.ndarray:
    """Pillow's ``Image.transform(size, AFFINE, matrix, NEAREST)`` onto a zero
    image of the same size: ``matrix`` maps an output pixel centre to the
    source, as Geometry.c steps it."""
    src = np.ascontiguousarray(arr, dtype=np.uint8)
    ch = 1 if src.ndim == 2 else src.shape[2]
    out = np.empty_like(src)
    a = np.asarray(matrix, np.float64)
    _load().cxr_affine_nearest(_ptr(src), src.shape[1], src.shape[0], ch, _ptr(a), _ptr(out))
    return out
