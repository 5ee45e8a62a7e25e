"""The port's JPEG codec, resampling, transforms, loaders, cache and device-side
input (cxrmate_torch/data/native, cxrmate_torch/data/image.py) against PIL and
the JAX package's cxrmate_tpu/data/image.py, bit for bit (device_preprocess
within 1e-5 in fp32).

PIL and JAX are imported inside the tests that compare with them, so that
this file imports on a machine with neither: there
``test_codec_matches_pil_fixtures`` holds the decoder to PIL's pixels stored
beside the committed fixture JPEGs (cxrmate_torch/tools/make_jpeg_fixtures.py).
"""

from __future__ import annotations

import glob
import io
import os
import random

import numpy as np
import pytest
import torch

from cxrmate_torch.data import image as ti
from cxrmate_torch.data import native

torch.set_num_threads(2)

FIXTURES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "cxrmate_torch", "tools", "jpeg_fixtures")


def _smooth(h, w, rgb=False, seed=0):
    """Band-limited content plus noise (what a radiograph JPEG holds)."""
    rs = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = 128 + 60 * np.sin(x / 7.0) * np.cos(y / 11.0) + 30 * np.sin((x + y) / 23.0)
    if rgb:
        base = np.stack([base, 255 - base, base * 0.5 + 40], -1)
    return np.clip(base + rs.normal(0, 12, base.shape), 0, 255).astype(np.uint8)


def _pil_jpeg(arr, **kw) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _pil_pixels(data: bytes) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(data)))


# ---------------------------------------------------------------------- codec
def test_codec_matches_pil_fixtures():
    """No PIL needed: each committed fixture decodes to the pixels PIL gave
    when the fixtures were made."""
    jpgs = sorted(glob.glob(os.path.join(FIXTURES, "*.jpg")))
    assert len(jpgs) >= 6, jpgs
    for p in jpgs:
        want = np.load(p[:-4] + ".npy")
        got = native.load_jpeg(p)
        assert got.shape == want.shape, p
        np.testing.assert_array_equal(got, want, err_msg=p)


@pytest.mark.parametrize("hw", [(37, 53), (48, 40), (500, 400)])
@pytest.mark.parametrize("quality", [75, 95])
@pytest.mark.parametrize("kind", ["gray", "420", "422", "444"])
def test_decode_equals_pil(kind, quality, hw):
    pytest.importorskip("PIL")
    rgb = kind != "gray"
    kw = dict(quality=quality)
    if rgb:
        kw["subsampling"] = {"444": 0, "422": 1, "420": 2}[kind]
    data = _pil_jpeg(_smooth(*hw, rgb=rgb), **kw)
    want = _pil_pixels(data)
    got = native.decode(data)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rgb", [False, True])
def test_decode_with_restart_markers_equals_pil(rgb):
    """DRI/RST: PIL-written (restart_marker_blocks) and the port's encoder's
    restart intervals of 1 and 3 MCUs; each held to PIL's decode."""
    pytest.importorskip("PIL")
    arr = _smooth(61, 97, rgb=rgb, seed=3)
    files = [_pil_jpeg(arr, restart_marker_blocks=2), _pil_jpeg(arr, restart_marker_rows=1)]
    files += [native.encode(arr, 75, ri) for ri in (1, 3)]
    for data in files:
        assert b"\xff\xdd" in data
        np.testing.assert_array_equal(native.decode(data), _pil_pixels(data))


@pytest.mark.parametrize("rgb", [False, True])
def test_encoder_files_decode_in_pil_to_the_port_pixels(rgb):
    """The port's encoder (libjpeg's defaults: quality 75, 4:2:0 for RGB):
    PIL reads its files to the pixels the port's decoder gives, at odd sizes
    and with restart intervals; here its bytes also equal PIL's ``save``."""
    pytest.importorskip("PIL")
    for hw in ((37, 53), (48, 40), (1, 1), (9, 17), (203, 131)):
        arr = _smooth(*hw, rgb=rgb, seed=hw[0])
        for ri in (0, 2):
            data = native.encode(arr, 75, ri)
            np.testing.assert_array_equal(_pil_pixels(data), native.decode(data))
        assert native.encode(arr) == _pil_jpeg(arr), hw


def _patched(data: bytes, find: bytes, repl: bytes) -> bytes:
    i = data.index(find)
    return data[:i] + repl + data[i + len(find):]


def test_unsupported_jpegs_raise_naming_the_file_and_feature():
    pytest.importorskip("PIL")
    from PIL import Image

    arr = _smooth(37, 53, rgb=True)
    base = _pil_jpeg(arr)
    cmyk = io.BytesIO()
    Image.fromarray(arr).convert("CMYK").save(cmyk, "JPEG")
    sof = base.index(b"\xff\xc0")
    no_jfif = base[:2] + base[base.index(b"\xff\xdb"):]  # APP0 dropped
    adobe = no_jfif[:2] + b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00\x00" + no_jfif[2:]
    rgb_ids = no_jfif.replace(b"\x03\x01\x22\x00\x02\x11\x01\x03\x11\x01", b"\x03R\x22\x00G\x11\x01B\x11\x01")

    def dc_table(counts: dict) -> bytes:
        """``base`` with DC table 0 redefined just before the scan: ``counts``
        maps a code length to its number of codes."""
        n = [counts.get(l, 0) for l in range(1, 17)]
        body = bytes([0x00] + n) + bytes(i % 12 for i in range(sum(n)))
        seg = b"\xff\xc4" + (2 + len(body)).to_bytes(2, "big") + body
        sos = base.index(b"\xff\xda")
        return base[:sos] + seg + base[sos:]

    bad_tables = {
        "oversubscribed": dc_table({1: 3}),
        "oversubscribed, long": dc_table({1: 255}),
        "oversubscribed at 2 bits": dc_table({1: 1, 2: 3}),
        "an all-ones code": dc_table({1: 2}),
        "an all-ones 9-bit code": dc_table({1: 1, 2: 1, 9: 128}),
    }
    for name, data in bad_tables.items():
        with pytest.raises(ValueError, match="bad.jpg: corrupt Huffman table"):
            native.decode(data, "bad.jpg")
        with pytest.raises(OSError):  # libjpeg refuses each table too
            Image.open(io.BytesIO(data)).load()
    cases = {
        "progressive": _pil_jpeg(arr, progressive=True),
        "arithmetic": base[:sof] + b"\xff\xc9" + base[sof + 2:],
        "12-bit": base[:sof + 4] + b"\x0c" + base[sof + 5:],
        "Adobe RGB": adobe,
        "component ids R, G, B": rgb_ids,
        "CMYK": cmyk.getvalue(),
        "truncated": base[: len(base) // 2],
        "not a JPEG": b"GIF89a" + base[6:],
    }
    assert rgb_ids != no_jfif
    for feature, data in cases.items():
        with pytest.raises(ValueError, match=f"bad.jpg: .*{feature}"):
            native.decode(data, "bad.jpg")


def test_missing_compiler_raises(monkeypatch):
    monkeypatch.delenv("CXX", raising=False)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        native._cxx()


# ----------------------------------------------------------- resize, rotation
@pytest.mark.parametrize("hw", [(500, 400), (400, 500), (64, 48), (40, 700), (1200, 1000)])
def test_resize_shortest_edge_matches_jax(hw):
    pytest.importorskip("PIL")
    from PIL import Image

    from cxrmate_tpu.data import image as ji

    for rgb in (False, True):
        arr = _smooth(*hw, rgb=rgb)
        want = np.asarray(ji.resize_shortest_edge(Image.fromarray(arr), 384))
        np.testing.assert_array_equal(ti.resize_shortest_edge(arr, 384), want)
    gray = _smooth(*hw)
    want = np.asarray(ji.resize_shortest_edge(Image.fromarray(gray).convert("RGB"), 64))
    np.testing.assert_array_equal(ti.to_rgb(ti.resize_shortest_edge(gray, 64)), want)


@pytest.mark.parametrize("angle", [-4.2, 0.0, 3.7])
def test_train_augment_matches_jax(angle):
    """The NEAREST rotation equals Image.rotate(angle, NEAREST, expand=False,
    fillcolor=0) after the crop, with the draws injected and drawn."""
    pytest.importorskip("PIL")
    from cxrmate_tpu.data import image as ji

    for hw in ((500, 400), (64, 48), (40, 700)):
        arr = _smooth(*hw, rgb=True, seed=hw[1])
        for crop in ((0, 0), None):
            got = ti.train_augment(arr, 32, random.Random(1), crop_ij=crop, angle=angle)
            want = ji.train_augment(arr, 32, random.Random(1), crop_ij=crop, angle=angle)
            np.testing.assert_array_equal(got, want)
        for seed in range(4):  # crop i, j and the angle drawn
            np.testing.assert_array_equal(ti.train_augment(arr, 32, random.Random(seed)),
                                          ji.train_augment(arr, 32, random.Random(seed)))


def test_rotation_fast_paths_and_large_angles_match_pil():
    pytest.importorskip("PIL")
    from PIL import Image

    arr = _smooth(32, 32, rgb=True)
    for angle in (45.0, 90.0, 180.0, 270.0, -30.0, 1e-3, 360.0):
        want = np.asarray(Image.fromarray(arr).rotate(angle, resample=Image.NEAREST, expand=False,
                                                      fillcolor=0))
        np.testing.assert_array_equal(ti.rotate_nearest(arr, angle), want)


# ------------------------------------------------------------------ loaders
def _jax_dataset(root):
    """A JAX-built synthetic dataset (PIL-written JPEGs) of larger images."""
    pytest.importorskip("pandas")
    from cxrmate_tpu.data.synthetic import build_synthetic_dataset

    paths = build_synthetic_dataset(str(root), n_train=3, n_val=1, n_test=1, image_hw=(70, 52))
    return sorted(glob.glob(os.path.join(paths["dataset_dir"], "**", "*.jpg"), recursive=True))


@pytest.mark.parametrize("cached", [False, True])
def test_eval_loader_matches_jax(tmp_path, cached):
    pytest.importorskip("PIL")
    from cxrmate_tpu.data import image as ji

    jpgs = _jax_dataset(tmp_path / "ds")
    rgb = tmp_path / "rgb.jpg"
    rgb.write_bytes(_pil_jpeg(_smooth(90, 70, rgb=True)))
    jpgs.append(str(rgb))
    kw = dict(cache_dir=str(tmp_path / ("cache" if cached else "none"))) if cached else {}
    port, ref = ti.make_eval_loader_transform(32, **kw), ji.make_eval_loader_transform(32)
    for p in jpgs:
        for _ in range(2 if cached else 1):  # a miss, then a hit
            got = port(p)
            assert got.dtype == np.float32 and got.shape == (3, 32, 32)
            np.testing.assert_array_equal(got, ref(p))


@pytest.mark.parametrize("cached", [False, True])
def test_train_loader_matches_jax(tmp_path, cached):
    """Epochs 0 and 1, against JAX's native_decode=False route."""
    pytest.importorskip("PIL")
    from cxrmate_tpu.data import image as ji

    jpgs = _jax_dataset(tmp_path / "ds")
    kw = dict(cache_dir=str(tmp_path / "cache")) if cached else {}
    port = ti.make_train_loader_transform(32, seed=3, **kw)
    ref = ji.make_train_loader_transform(32, seed=3, native_decode=False)
    for epoch in (0, 1):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        for p in jpgs:
            np.testing.assert_array_equal(port(p), ref(p))


def _hide_source(path):
    """Overwrite a JPEG in place, keeping its size and mtime (the cache key):
    a load must then come from the cache."""
    st = os.stat(path)
    with open(path, "r+b") as f:
        f.write(b"x" * st.st_size)
    os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cache_entries_serve_the_other_package(tmp_path, writer):
    """Same keys, variants and bytes: an entry written by one package's eval
    or train loader is served by the other's, and its .npy bytes are equal."""
    pytest.importorskip("PIL")
    from cxrmate_tpu.data import image as ji

    src = _jax_dataset(tmp_path / "ds")[0]
    cold = {"eval": ji.make_eval_loader_transform(32)(src),
            "train": ji.make_train_loader_transform(32, seed=5, native_decode=False)(src)}
    caches = {}
    for pkg in ("jax", "port"):
        d = str(tmp_path / f"cache-{pkg}")
        mod = ji if pkg == "jax" else ti
        train_kw = {"native_decode": False} if pkg == "jax" else {}
        caches[pkg] = (mod.make_eval_loader_transform(32, cache_dir=d),
                       mod.make_train_loader_transform(32, seed=5, cache_dir=d, **train_kw), d)
        caches[pkg][0](src)
        caches[pkg][1](src)
    files = {pkg: sorted(glob.glob(os.path.join(c[2], "*", "*.npy"))) for pkg, c in caches.items()}
    assert len(files["jax"]) == 2
    assert [os.path.basename(f) for f in files["jax"]] == [os.path.basename(f) for f in files["port"]]
    for a, b in zip(files["jax"], files["port"]):
        assert open(a, "rb").read() == open(b, "rb").read()
    reader = "port" if writer == "jax" else "jax"
    for f in glob.glob(os.path.join(caches[reader][2], "*", "*.npy")):
        os.remove(f)
    for a in files[writer]:
        os.makedirs(os.path.dirname(a.replace(caches[writer][2], caches[reader][2])), exist_ok=True)
        with open(a, "rb") as fa, open(a.replace(caches[writer][2], caches[reader][2]), "wb") as fb:
            fb.write(fa.read())
    _hide_source(src)
    np.testing.assert_array_equal(caches[reader][0](src), cold["eval"])
    np.testing.assert_array_equal(caches[reader][1](src), cold["train"])


def test_cache_warmer_and_thread_independent_draws(tmp_path):
    """``warm`` fills the cache once; a CacheWarmer run serves every path;
    the train loader's draws do not depend on the thread schedule."""
    from concurrent.futures import ThreadPoolExecutor

    paths = []
    for i in range(5):
        p = tmp_path / f"im{i}.jpg"
        p.write_bytes(native.encode(_smooth(60, 44, seed=i)))
        paths.append(str(p))
    d = str(tmp_path / "cache")
    load = ti.make_eval_loader_transform(32, cache_dir=d)
    train = ti.make_train_loader_transform(32, seed=2, cache_dir=d)
    cold = [ti.make_eval_loader_transform(32)(p) for p in paths]
    with ti.CacheWarmer([(load, paths), (train, paths)], workers=3) as warmer:
        for t in warmer.threads:
            t.join(timeout=30)
    assert len(glob.glob(os.path.join(d, "*", "*.npy"))) == 10
    serial = [train(p) for p in paths]
    for p in paths:
        _hide_source(p)
    for got, want in zip([load(p) for p in paths], cold):
        np.testing.assert_array_equal(got, want)
    with ThreadPoolExecutor(4) as pool:
        threaded = list(pool.map(train, reversed(paths)))[::-1]
    for a, b in zip(serial, threaded):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------- device ops
def test_device_normalize_gray_u8_matches_jax_in_bf16_bits():
    import jax.numpy as jnp

    from cxrmate_tpu.data import image as ji

    px = np.random.RandomState(0).randint(0, 256, (2, 3, 40, 36)).astype(np.uint8)
    want = np.asarray(ji.device_normalize_gray_u8(jnp.asarray(px)).astype(jnp.float32))
    got = ti.device_normalize_gray_u8(torch.from_numpy(px))
    assert got.dtype == torch.bfloat16 and got.shape == (2, 3, 3, 40, 36)
    np.testing.assert_array_equal(got.float().numpy(), want)
    host = torch.from_numpy(np.stack([ti.normalize_chw(ti.to_rgb(p)) for p in px.reshape(-1, 40, 36)]))
    np.testing.assert_array_equal(got.reshape(-1, 3, 40, 36).float().numpy(),
                                  host.to(torch.bfloat16).float().numpy())


@pytest.mark.parametrize("hw,size", [((40, 52), 64), ((100, 77), 48)])
def test_device_preprocess_matches_jax(hw, size):
    """An upscale and a downscale, fp32, within 1e-5."""
    import jax.numpy as jnp

    from cxrmate_tpu.data import image as ji

    px = np.random.RandomState(1).randint(0, 256, (2, *hw, 3)).astype(np.uint8)
    want = np.asarray(ji.device_preprocess(jnp.asarray(px), size))
    got = ti.device_preprocess(torch.from_numpy(px), size)
    assert got.dtype == torch.float32 and got.shape == (2, 3, size, size)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
