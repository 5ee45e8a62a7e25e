"""The port's JPEG codec and Pillow-exact resampling (``jpeg.cpp``), by ctypes.

The port depends on neither PIL nor libjpeg, so it carries its own baseline
decoder, whose output equals libjpeg(-turbo)'s defaults (and so PIL's) byte
for byte, a baseline encoder with libjpeg's defaults, and Pillow's bilinear
resize and nearest affine transform.

The training loaders' routes of ``cxrmate_tpu/data/native`` are here too,
with libjpeg's bits: the DCT-scaled decode (``decode_jpeg(data, denom)``,
``pick_scale_denom``, ``load_jpeg_scaled``) and the fused fast decode and
float bilinear resize (``decode_jpeg_resized``, ``load_jpeg_resized``;
JDCT_IFAST, gray out for a gray source). Where the JAX functions return
None on a failure and leave the caller to fall back to PIL, these raise;
the one None is the JAX package's own: a source smaller than the fast
route's target.

``jpeg.cpp`` is built at first use by the host C++ compiler into
``cxrmate_torch/_build/jpeg-<hash>/`` (``utils/host_build.py``); it is a
library of its own, so the CPU builds and runs it too. No compiler raises.
A JPEG outside the decoder's set raises ``ValueError`` naming the file and
the feature; nothing falls back to another decoder.
The calls are plain ctypes calls, which release the GIL, so a loader's
thread pool decodes in parallel.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

from cxrmate_torch.utils.host_build import build_library

SOURCE = Path(__file__).resolve().parent / "jpeg.cpp"
LIB_NAME = "libcxrmate_jpeg.so"
# no FMA contraction: the resampling's double arithmetic must round as Pillow's does
COMPILE_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off")

_lock = threading.Lock()
_lib = None
_ERR = 512


def build() -> Path:
    """Path of the codec library, compiling it first if this source hash has
    not been built. Raises with the compiler's output if it fails."""
    return build_library("jpeg", SOURCE, LIB_NAME, COMPILE_FLAGS)


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i, sz, s = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t, ctypes.c_char_p
            ip = ctypes.POINTER(ctypes.c_int)
            for name, args in (
                ("cxr_jpeg_info", [p, sz, i, ip, ip, ip, s, i]),
                ("cxr_jpeg_decode", [p, sz, i, p, s, i]),
                ("cxr_jpeg_decode_resized", [p, sz, i, i, i, i, p, s, i]),
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


def jpeg_info(data: bytes, denom: int = 1, name: str = "<bytes>") -> Tuple[int, int, int]:
    """(width, height, components) of the decode at 1/``denom``: libjpeg's
    output size, ceil(size / denom)."""
    buf = np.frombuffer(data, np.uint8)
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = ctypes.create_string_buffer(_ERR)
    if _load().cxr_jpeg_info(_ptr(buf), buf.size, int(denom), ctypes.byref(w), ctypes.byref(h),
                             ctypes.byref(c), err, _ERR):
        raise ValueError(f"{name}: {err.value.decode()}")
    return w.value, h.value, c.value


def decode(data: bytes, name: str = "<bytes>", denom: int = 1) -> np.ndarray:
    """JPEG bytes -> uint8 [H, W] (one component) or [H, W, 3] (RGB), the
    pixels PIL's ``np.asarray(Image.open(...))`` gives; at 1/``denom`` of the
    size (1, 2, 4 or 8), libjpeg's pixels for that scale. Raises
    ``ValueError`` naming ``name`` and what is not supported."""
    w, h, c = jpeg_info(data, denom, name)
    buf = np.frombuffer(data, np.uint8)
    out = np.empty((h, w) if c == 1 else (h, w, 3), np.uint8)
    err = ctypes.create_string_buffer(_ERR)
    if _load().cxr_jpeg_decode(_ptr(buf), buf.size, int(denom), _ptr(out), err, _ERR):
        raise ValueError(f"{name}: {err.value.decode()}")
    return out


def decode_jpeg(data: bytes, scale_denom: int = 1, name: str = "<bytes>") -> np.ndarray:
    """JPEG bytes -> RGB uint8 [H, W, 3] at 1/``scale_denom`` (a gray source
    replicated, as libjpeg's JCS_RGB output does): the counterpart of
    ``cxrmate_tpu.data.native.decode_jpeg``."""
    return _rgb(decode(data, name, scale_denom))


def _rgb(arr: np.ndarray) -> np.ndarray:
    """libjpeg's JCS_RGB output of a decode: one component replicated."""
    return np.repeat(arr[:, :, None], 3, axis=2) if arr.ndim == 2 else arr


def pick_scale_denom(data: bytes, target_shortest: int, name: str = "<bytes>") -> int:
    """The largest denom in {1, 2, 4, 8} that keeps the full-scale shortest
    edge // denom at or above ``target_shortest``."""
    w, h, _ = jpeg_info(data, 1, name)
    shortest, denom = min(w, h), 1
    for d in (2, 4, 8):
        if shortest // d >= target_shortest:
            denom = d
    return denom


def decode_scaled(data: bytes, target_shortest: int, name: str = "<bytes>") -> np.ndarray:
    """The scaled decode of ``load_jpeg_scaled`` in the source's own layout
    ([H, W] for one component): the loaders resize the one gray channel."""
    return decode(data, name, pick_scale_denom(data, target_shortest, name))


def load_jpeg_scaled(path: str, target_shortest: int) -> np.ndarray:
    """Read and decode a JPEG as RGB at the largest DCT scale that keeps the
    shortest edge at or above ``target_shortest``."""
    with open(path, "rb") as f:
        return _rgb(decode_scaled(f.read(), target_shortest, path))


def decode_jpeg_resized(data: bytes, target_shortest: int, gray: bool = True,
                        fast_dct: bool = True, name: str = "<bytes>") -> Optional[np.ndarray]:
    """The fast loader's fused step: the DCT-scaled decode (JDCT_IFAST where
    ``fast_dct``) and the float bilinear resize to torchvision's
    shortest-edge size of the full-scale dims (long edge truncated). uint8
    [H, W] where ``gray`` and the source has one component, else [H, W, 3]
    (a colour source in gray mode comes back RGB, as the JAX route's retry
    gives it). None for a source whose shortest edge is below the target."""
    fw, fh, comps = jpeg_info(data, 1, name)
    if min(fh, fw) < target_shortest:
        return None
    if fw <= fh:
        ow, oh = target_shortest, int(target_shortest * fh / fw)
    else:
        ow, oh = int(target_shortest * fw / fh), target_shortest
    denom = pick_scale_denom(data, target_shortest, name)
    out = np.empty((oh, ow) if comps == 1 else (oh, ow, 3), np.uint8)
    buf = np.frombuffer(data, np.uint8)
    err = ctypes.create_string_buffer(_ERR)
    if _load().cxr_jpeg_decode_resized(_ptr(buf), buf.size, denom, int(bool(fast_dct)), oh, ow,
                                       _ptr(out), err, _ERR):
        raise ValueError(f"{name}: {err.value.decode()}")
    # libjpeg's gray -> RGB replicates before the resize
    return out if gray else _rgb(out)


def load_jpeg_resized(path: str, target_shortest: int, gray: bool = True,
                      fast_dct: bool = True) -> Optional[np.ndarray]:
    """Read a JPEG and run :func:`decode_jpeg_resized` on it."""
    with open(path, "rb") as f:
        data = f.read()
    return decode_jpeg_resized(data, target_shortest, gray, fast_dct, path)


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
