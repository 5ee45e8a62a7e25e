"""Image loading and preprocessing without PIL.

The port's copy of ``cxrmate_tpu/data/image.py``. The reference's transforms
(`modules/lightning_modules/single.py:230-262`) are: Resize(shortest_edge=384,
bilinear) -> Center/RandomCrop(384, pad_if_needed) -> [RandomRotation(+-5)]
-> ToTensor -> Normalize(ImageNet mean/std), on PIL images. Here they work on
uint8 numpy arrays: the port's JPEG decoder (``data/native``) gives PIL's
pixels, its resize is Pillow's bilinear resampling and its rotation Pillow's
nearest affine transform, bit for bit, so the eval loader stays PIL-exact.

The decoded-image cache stores each loader's deterministic uint8 prefix
(resize + crop for eval, resize for train) under the JAX package's keys and
variants ("eval", "train-pil"), with the same bytes: a cache warmed by
either package serves the other.

The device side (``device_normalize_gray_u8``, ``device_preprocess``) is
plain PyTorch on an explicit device.
"""

from __future__ import annotations

import hashlib
import itertools
import math
import os
import random
import threading
import zlib
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np

from cxrmate_torch.data import native

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def load_image(path: str) -> np.ndarray:
    """The JPEG at ``path`` as uint8 [H, W] (gray) or [H, W, 3] (RGB)."""
    return native.load_jpeg(path)


def to_rgb(arr: np.ndarray) -> np.ndarray:
    """Gray [H, W] -> [H, W, 3] (PIL's convert("RGB")); RGB as it is."""
    return np.stack([arr] * 3, axis=-1) if arr.ndim == 2 else arr


def resize_shortest_edge(arr: np.ndarray, size: int) -> np.ndarray:
    """torchvision Resize(int) semantics: shortest edge -> size, long edge scaled
    with int truncation (torchvision _compute_resized_output_size), Pillow's
    bilinear resampling."""
    h, w = arr.shape[:2]
    if w <= h:
        nw, nh = size, int(size * h / w)
    else:
        nw, nh = int(size * w / h), size
    if (nw, nh) == (w, h):
        return arr
    return native.resize_bilinear(arr, (nw, nh))


def center_crop(arr: np.ndarray, size: int) -> np.ndarray:
    h, w = arr.shape[:2]
    if h < size or w < size:  # pad_if_needed semantics
        pad_h, pad_w = max(size - h, 0), max(size - w, 0)
        arr = np.pad(arr, ((pad_h // 2, pad_h - pad_h // 2), (pad_w // 2, pad_w - pad_w // 2), (0, 0)))
        h, w = arr.shape[:2]
    top = int(round((h - size) / 2.0))
    left = int(round((w - size) / 2.0))
    return arr[top : top + size, left : left + size]


def random_crop(arr: np.ndarray, size: int, rng: random.Random) -> np.ndarray:
    arr = pad_if_needed(arr, size)
    h, w = arr.shape[:2]
    top = rng.randint(0, h - size)
    left = rng.randint(0, w - size)
    return arr[top : top + size, left : left + size]


def pad_if_needed(arr: np.ndarray, size: int) -> np.ndarray:
    """torchvision RandomCrop(pad_if_needed=True) semantics: pads (size - dim) on
    BOTH sides of a short dimension (transforms.RandomCrop.forward), unlike
    CenterCrop's split-half padding."""
    h, w = arr.shape[:2]
    pad_h, pad_w = max(size - h, 0), max(size - w, 0)
    if pad_h or pad_w:
        arr = np.pad(arr, ((pad_h, pad_h), (pad_w, pad_w), (0, 0)))
    return arr


def normalize_chw(arr_hwc_u8: np.ndarray) -> np.ndarray:
    """uint8 HWC -> normalized float32 CHW (ToTensor + Normalize)."""
    x = arr_hwc_u8.astype(np.float32) / 255.0
    x = (x - IMAGENET_MEAN) / IMAGENET_STD
    return np.transpose(x, (2, 0, 1))


def rotate_nearest(arr: np.ndarray, angle: float) -> np.ndarray:
    """``Image.rotate(angle, NEAREST, expand=False, fillcolor=0)`` of a uint8
    [H, W(, C)] array: counter-clockwise for positive angles, with Pillow's
    fast paths and its inverse affine matrix (``round(..., 15)`` terms)."""
    angle = angle % 360.0
    h, w = arr.shape[:2]
    if angle == 0:
        return arr.copy()
    if angle == 180:
        return np.ascontiguousarray(arr[::-1, ::-1])
    if angle in (90, 270) and w == h:
        return np.ascontiguousarray(np.rot90(arr, 1 if angle == 90 else -1))
    cx, cy = w / 2, h / 2
    angle = -math.radians(angle)
    m = [round(math.cos(angle), 15), round(math.sin(angle), 15), 0.0,
         round(-math.sin(angle), 15), round(math.cos(angle), 15), 0.0]
    a, b, c, d, e, f = m
    m[2], m[5] = a * -cx + b * -cy + c, d * -cx + e * -cy + f
    m[2] += cx
    m[5] += cy
    return native.affine_nearest(arr, m)


def eval_transform_u8(arr: np.ndarray, size: int = 384) -> np.ndarray:
    """The deterministic uint8 prefix of ``eval_transform`` (resize -> gray->RGB
    stack -> center crop): the part the decoded-image cache stores."""
    return center_crop(to_rgb(resize_shortest_edge(arr, size)), size)


def eval_transform(arr: np.ndarray, size: int = 384) -> np.ndarray:
    return normalize_chw(eval_transform_u8(arr, size))


def train_transform(arr: np.ndarray, size: int = 384, rng: Optional[random.Random] = None,
                    rotation_degrees: float = 5.0,
                    crop_ij: Optional[Tuple[int, int]] = None,
                    angle: Optional[float] = None) -> np.ndarray:
    """The reference train pipeline in order (single.py:230-241): Resize(shortest
    edge) -> RandomCrop(384, pad_if_needed) -> RandomRotation(+-5, NEAREST,
    expand False, fill 0) -> ToTensor -> Normalize. ``crop_ij``/``angle``
    inject the random parameters; by default they are drawn from ``rng`` in
    the order torchvision draws them (crop i, j, then angle)."""
    return train_augment(to_rgb(resize_shortest_edge(arr, size)), size, rng, rotation_degrees,
                         crop_ij, angle)


def train_augment(arr: np.ndarray, size: int, rng: Optional[random.Random] = None,
                  rotation_degrees: float = 5.0,
                  crop_ij: Optional[Tuple[int, int]] = None,
                  angle: Optional[float] = None) -> np.ndarray:
    """The augmentation tail of ``train_transform``, taking the already
    resized RGB uint8 HWC array (what the decoded-image cache stores)."""
    rng = rng or random.Random()
    arr = pad_if_needed(arr, size)
    h, w = arr.shape[:2]
    if crop_ij is None:
        crop_ij = (rng.randint(0, h - size), rng.randint(0, w - size))
    top, left = crop_ij
    arr = arr[top : top + size, left : left + size]
    if angle is None:
        angle = rng.uniform(-rotation_degrees, rotation_degrees)
    return normalize_chw(rotate_nearest(arr, angle))


# ----------------------------------------------------------- decoded-image cache
# An on-disk cache of each loader's deterministic uint8 prefix, keyed by
# absolute path + source (mtime_ns, size) + target size + variant, so source
# changes invalidate automatically; writes are tmp+rename-atomic for
# concurrent loader pools. Gray sources store one channel. The keys, variants
# and bytes are the JAX package's (cxrmate_tpu/data/image.py:151).


def _cache_file(cache_dir: str, path: str, size: int, variant: str) -> str:
    st = os.stat(path)
    key = hashlib.sha1(
        f"{os.path.abspath(path)}|{st.st_mtime_ns}|{st.st_size}|{size}|{variant}".encode()
    ).hexdigest()
    return os.path.join(cache_dir, key[:2], key + ".npy")


def _cache_get(cache_file: str) -> Optional[np.ndarray]:
    try:
        return np.load(cache_file)
    except Exception:  # noqa: BLE001 - miss/corrupt/partial -> recompute
        return None


def _cache_put(cache_file: str, arr: np.ndarray) -> None:
    try:
        os.makedirs(os.path.dirname(cache_file), exist_ok=True)
        tmp = f"{cache_file}.tmp.{os.getpid()}.{id(arr)}"
        with open(tmp, "wb") as f:  # np.save(str) would append its own .npy
            np.save(f, arr)
        os.replace(tmp, cache_file)
    except OSError:  # cache dir unwritable/full: keep serving uncached
        pass


class CacheWarmer:
    """Background decoded-image-cache warmer: decodes a stage's image files
    into the cache on daemon threads while the stage starts, with the
    loader's own tmp+rename-atomic ``_cache_put`` (racing the stage's own
    loader pool is safe: both write the same bytes). A context manager;
    ``stop()`` halts the threads, which also exit when the work runs out.

    ``jobs``: [(load_fn, paths), ...], warmed in order. A loader with a
    ``warm`` attribute (the cached factories below) is warmed through that
    decode-only entry point."""

    def __init__(self, jobs, workers: Optional[int] = None):
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._work = itertools.chain.from_iterable(
            ((getattr(load, "warm", load), p) for p in paths) for load, paths in jobs
        )
        n = workers or min(8, os.cpu_count() or 1)
        self.threads = [
            threading.Thread(target=self._run, daemon=True, name=f"cache-warmer-{i}")
            for i in range(n)
        ]
        for t in self.threads:
            t.start()

    def _run(self):
        while not self._stop.is_set():
            with self._lock:
                item = next(self._work, None)
            if item is None:
                return
            load, path = item
            try:
                load(path)
            except Exception:  # noqa: BLE001 - corrupt file: the stage's own
                pass           # loader will surface the real error with context

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        for t in self.threads:
            t.join(timeout=timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
        return False


def _one_channel_if_gray(a: np.ndarray) -> np.ndarray:
    """A replicated-gray RGB array as its one channel (3x less cache traffic)."""
    if a.ndim == 3 and (a[:, :, 0] == a[:, :, 1]).all() and (a[:, :, 0] == a[:, :, 2]).all():
        return a[:, :, 0]
    return a


def make_eval_loader_transform(size: int = 384, cache_dir: Optional[str] = None):
    """PIL-exact eval loader (single.py:248-262): path -> float32 [3, size,
    size]. ``cache_dir`` caches the cropped uint8 intermediate (variant
    "eval"; a gray source stores one channel, as the JAX loader does)."""

    def decode_for_cache(path: str) -> np.ndarray:
        a = _one_channel_if_gray(resize_shortest_edge(load_image(path), size))
        if a.ndim == 2:
            return center_crop(a[:, :, None], size)[:, :, 0]
        return center_crop(a, size)

    def load(path: str) -> np.ndarray:
        if cache_dir is None:
            return eval_transform(load_image(path), size)
        cf = _cache_file(cache_dir, path, size, "eval")
        arr = _cache_get(cf)
        if arr is None:
            arr = decode_for_cache(path)
            _cache_put(cf, arr)
        return normalize_chw(to_rgb(arr))

    if cache_dir is not None:
        load.warm = _make_warm(cache_dir, size, "eval", decode_for_cache)
    return load


def _make_warm(cache_dir: str, size: int, variant: str, decode_for_cache):
    """Decode-only cache-fill entry point (``load.warm``): skips the
    normalize/augment tail, and the decode where the entry exists."""

    def warm(path: str) -> None:
        cf = _cache_file(cache_dir, path, size, variant)
        if not os.path.exists(cf):
            _cache_put(cf, decode_for_cache(path))

    return warm


def make_train_loader_transform(size: int = 384, seed: int = 0, cache_dir: Optional[str] = None):
    """Training loader: a full-scale decode, the shortest-edge resize, then
    the augmentation tail; the JAX loader's ``native_decode=False`` route
    (its DCT-scaled decode is not ported). Augmentation draws come from a
    per-call RNG seeded by (seed, epoch, path): deterministic regardless of
    loader-thread scheduling, varying across epochs. ``load.set_epoch(e)``
    advances the epoch. ``cache_dir`` caches the resized uint8 image
    (variant "train-pil"; the epoch is not in the key)."""
    state = {"epoch": 0}

    def decode_resized_rgb(path: str) -> np.ndarray:
        return to_rgb(resize_shortest_edge(load_image(path), size))

    def decode_for_cache(path: str) -> np.ndarray:
        return _one_channel_if_gray(resize_shortest_edge(load_image(path), size))

    def load(path: str) -> np.ndarray:
        rng = random.Random(
            (seed * 1_000_003 + state["epoch"]) * 4_294_967_291 + zlib.crc32(path.encode())
        )
        if cache_dir is None:
            return train_augment(decode_resized_rgb(path), size, rng)
        cf = _cache_file(cache_dir, path, size, "train-pil")
        arr = _cache_get(cf)
        if arr is None:
            arr = decode_for_cache(path)
            _cache_put(cf, arr)
        return train_augment(to_rgb(arr), size, rng)

    load.set_epoch = lambda e: state.__setitem__("epoch", int(e))
    if cache_dir is not None:
        load.warm = _make_warm(cache_dir, size, "train-pil", decode_for_cache)
    return load


# ------------------------------------------------------------- device-side path
def device_normalize_gray_u8(pixels_u8):
    """Gray uint8 [..., H, W] (a torch tensor on any device) ->
    ImageNet-normalized bfloat16 [..., 3, H, W] (gray->RGB replication like
    PIL convert("RGB")), in fp32 in the JAX package's order: x / 255, then
    (x - mean) / std. The divisors are tensors on the input's device, so
    every step is a true division."""
    import torch

    dev = pixels_u8.device
    mean = torch.as_tensor(IMAGENET_MEAN, device=dev)[:, None, None]
    std = torch.as_tensor(IMAGENET_STD, device=dev)[:, None, None]
    x = pixels_u8[..., None, :, :].to(torch.float32) / torch.tensor(255.0, device=dev)
    return ((x - mean) / std).to(torch.bfloat16)  # mean [3,1,1] broadcasts to 3ch


@lru_cache(maxsize=32)
def _triangle_weights(in_size: int, out_size: int) -> np.ndarray:
    """jax.image.resize's antialiased bilinear (triangle) weights for one axis,
    [in_size, out_size] in float32 (jax/_src/image/scale.py
    _compute_weight_mat with scale out/in, translation 0)."""
    f32 = np.float32
    inv_scale = f32(1.0 / (out_size / in_size))  # Python floats, then the weak float32
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    weights = np.maximum(f32(0.0), f32(1.0) - np.abs(x)).astype(f32)
    total = np.sum(weights, axis=0, keepdims=True, dtype=f32)
    safe = np.where(total != 0, total, f32(1.0))
    weights = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                       weights / safe, f32(0.0)).astype(f32)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], weights, f32(0.0)).astype(f32)


def device_preprocess(batch_u8, size: int = 384):
    """[B, H, W, 3] uint8 (a torch tensor) -> [B, 3, size, size] normalized
    float32 on the same device: jax.image.resize's antialiased bilinear
    resize (its triangle weights as two matrices, applied by ``torch.matmul``
    over H, then W), the center crop, and the normalisation. Approximate (not
    PIL-bit-exact): for training and throughput."""
    import torch

    dev = batch_u8.device
    b, h, w, c = batch_u8.shape
    scale = size / min(h, w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    wh = torch.as_tensor(_triangle_weights(h, nh), device=dev)
    ww = torch.as_tensor(_triangle_weights(w, nw), device=dev)
    x = batch_u8.to(torch.float32).permute(0, 3, 2, 1)         # [B, C, W, H]
    x = torch.matmul(x, wh)                                    # [B, C, W, nh]
    x = torch.matmul(x.transpose(2, 3), ww)                    # [B, C, nh, nw]
    top, left = (nh - size) // 2, (nw - size) // 2
    x = x[:, :, top : top + size, left : left + size]
    x = x / torch.tensor(255.0, device=dev)
    mean = torch.as_tensor(IMAGENET_MEAN, device=dev)[:, None, None]
    std = torch.as_tensor(IMAGENET_STD, device=dev)[:, None, None]
    return ((x - mean) / std).contiguous()
