"""The port's DCT-scaled and fast JPEG decodes (cxrmate_torch/data/native) and
the loaders on them (cxrmate_torch/data/image.py) against the JAX package's
libjpeg routes (cxrmate_tpu/data/native, cxrmate_tpu/data/image.py), bit for
bit: the committed route fixtures, seeded sources of every sampling the
decoder takes, the train and fast loaders with their cache files, and the
CLI's train batch on sources at least twice ``image_size``.

PIL makes the seeded sources; libjpeg (through ``cxrmate_tpu.data.native``)
is the reference, and a test that needs it skips, naming the reason, where
that library does not build.
"""

from __future__ import annotations

import glob
import io
import os

import numpy as np
import pytest
import torch

from cxrmate_torch.data import image as ti
from cxrmate_torch.data import native
from cxrmate_torch.tools import make_jpeg_fixtures as fx

torch.set_num_threads(2)


def _libjpeg():
    from cxrmate_tpu.data import native as jn

    if not jn.available():
        pytest.skip("cxrmate_tpu.data.native (gcc and libjpeg) does not build here")
    return jn


def _smooth(h, w, rgb=False, seed=0):
    """Band-limited content plus strong noise (every coefficient in use)."""
    rs = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = 128 + 60 * np.sin(x / 7.0) * np.cos(y / 11.0) + 30 * np.sin((x + y) / 23.0)
    if rgb:
        base = np.stack([base, 255 - base, base * 0.5 + 40], -1)
    return np.clip(base + rs.normal(0, 25, base.shape), 0, 255).astype(np.uint8)


# name: (height, width, rgb, PIL save arguments)
SOURCES = {
    "ycc444": (211, 317, True, dict(quality=90, subsampling=0)),
    "ycc422": (300, 457, True, dict(quality=80, subsampling=1)),
    "ycc420": (517, 389, True, dict(quality=75, subsampling=2)),
    "gray": (263, 401, False, dict(quality=85)),
    "ycc420_restart": (333, 229, True, dict(quality=70, subsampling=2, restart_marker_blocks=3)),
}


@pytest.fixture(scope="module")
def sources():
    from PIL import Image

    out = {}
    for seed, (name, (h, w, rgb, kw)) in enumerate(SOURCES.items()):
        buf = io.BytesIO()
        Image.fromarray(_smooth(h, w, rgb, seed)).save(buf, "JPEG", **kw)
        out[name] = buf.getvalue()
    return out


# ------------------------------------------------------------------ fixtures
def test_route_fixtures_equal_libjpeg():
    """Each committed route fixture is libjpeg's output on its JPEG, and the
    port's codec gives it."""
    jn = _libjpeg()
    cases = fx.route_fixtures()
    assert len(cases) >= 7 * 8
    denoms = set()
    for jpg, npy, fn, kw in cases:
        want = np.load(npy)
        ref = getattr(jn, fn)(jpg, **kw)
        assert ref is not None and ref.shape == want.shape, npy
        np.testing.assert_array_equal(ref, want, err_msg=npy)
        np.testing.assert_array_equal(getattr(native, fn)(jpg, **kw), want, err_msg=npy)
        data = open(jpg, "rb").read()
        denoms.add(native.pick_scale_denom(data, kw["target_shortest"]))
    assert denoms == {1, 2, 4, 8}


# ------------------------------------------------------------ seeded sources
@pytest.mark.parametrize("name", list(SOURCES))
def test_scaled_decode_equals_libjpeg(sources, name):
    """Dims (rounded up) and pixels at every denom; gray replicated to RGB."""
    jn = _libjpeg()
    data = sources[name]
    h, w = SOURCES[name][:2]
    for d in (1, 2, 4, 8):
        got, want = native.decode_jpeg(data, d), jn.decode_jpeg(data, d)
        assert got.shape == want.shape == (-(-h // d), -(-w // d), 3)
        np.testing.assert_array_equal(got, want, err_msg=f"{name} 1/{d}")
    for t in (h // 8, min(h, w) // 2, min(h, w) // 3):
        assert native.pick_scale_denom(data, t) == jn.pick_scale_denom(data, t)


@pytest.mark.parametrize("name", list(SOURCES))
def test_fast_decode_equals_libjpeg_in_every_mode(sources, name):
    """Gray and RGB, IFAST and ISLOW, at targets reaching denoms 1-8; None
    where the source is smaller than the target."""
    jn = _libjpeg()
    data = sources[name]
    s = min(SOURCES[name][:2])
    for t in (s // 8, s // 4 - 3, s // 2, s - 7, s, s + 1):
        for gray in (True, False):
            for fast in (True, False):
                got = native.decode_jpeg_resized(data, t, gray, fast)
                want = jn.decode_jpeg_resized(data, t, gray, fast)
                if want is None:
                    assert got is None and t > s
                    continue
                assert got.shape == want.shape, (name, t, gray, fast)
                np.testing.assert_array_equal(got, want, err_msg=f"{name} {t} {gray} {fast}")


def test_fast_dct_changes_pixels_at_full_scale(sources):
    """IFAST is its own IDCT: at denom 1 (a target of the shortest edge) the
    fast route gives other pixels than with ISLOW; at denoms 2-8 a gray
    source's blocks are reduced, where libjpeg runs no IFAST."""
    data = sources["gray"]
    s = min(SOURCES["gray"][:2])

    def fast(target, ifast):
        return native.decode_jpeg_resized(data, target, fast_dct=ifast)

    assert native.pick_scale_denom(data, s) == 1
    assert (fast(s, True) != fast(s, False)).any()
    for d in (2, 4, 8):
        assert native.pick_scale_denom(data, s // d) == d
        np.testing.assert_array_equal(fast(s // d, True), fast(s // d, False))


def test_scaled_decode_refuses_other_denoms(sources):
    with pytest.raises(ValueError, match="scale denominator"):
        native.decode(sources["gray"], "x.jpg", denom=3)


# -------------------------------------------------------------------- loaders
def _write_sources(tmp_path, sources):
    paths = []
    for name, data in sources.items():
        p = tmp_path / f"{name}.jpg"
        p.write_bytes(data)
        paths.append(str(p))
    p = tmp_path / "small_rgb.jpg"  # below the fast loader's target: its PIL route
    p.write_bytes(_jpeg(_smooth(40, 30, rgb=True, seed=9)))
    paths.append(str(p))
    return paths


def _jpeg(arr) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "JPEG")
    return buf.getvalue()


def _cache_tree(d):
    return {os.path.relpath(f, d): open(f, "rb").read()
            for f in sorted(glob.glob(os.path.join(d, "*", "*.npy")))}


@pytest.mark.parametrize("size", [32, 64])
def test_loaders_and_cache_files_equal_jax(tmp_path, sources, size):
    """The native train loader (epochs 0 and 1) and the fast loader (gray
    and normalized), cold and from the cache; the cache trees byte for
    byte."""
    _libjpeg()
    from cxrmate_tpu.data import image as ji

    paths = _write_sources(tmp_path, sources)
    cp, cj = str(tmp_path / "cache-port"), str(tmp_path / "cache-jax")
    port = [ti.make_train_loader_transform(size, seed=7), ti.make_fast_eval_loader_transform(size),
            ti.make_fast_eval_loader_transform(size, normalize=True),
            ti.make_train_loader_transform(size, seed=7, cache_dir=cp),
            ti.make_fast_eval_loader_transform(size, cache_dir=cp)]
    ref = [ji.make_train_loader_transform(size, seed=7), ji.make_fast_eval_loader_transform(size),
           ji.make_fast_eval_loader_transform(size, normalize=True),
           ji.make_train_loader_transform(size, seed=7, cache_dir=cj),
           ji.make_fast_eval_loader_transform(size, cache_dir=cj)]
    for epoch in (0, 1):
        for load in port[::3] + ref[::3]:
            load.set_epoch(epoch)
        for p in paths:
            for a, b in zip(port, ref):
                got, want = a(p), b(p)
                assert got.dtype == want.dtype and got.shape == want.shape
                np.testing.assert_array_equal(got, want, err_msg=p)
    tree_p, tree_j = _cache_tree(cp), _cache_tree(cj)
    assert len(tree_j) == 2 * len(paths)
    assert list(tree_p) == list(tree_j)
    assert all(tree_p[k] == tree_j[k] for k in tree_j)


def test_train_batch_of_make_datasets_equals_jax(tmp_path):
    """The CLI's train split through the native route: sources of 140 x 131
    at image_size 32 decode at 1/4."""
    _libjpeg()
    from cxrmate_tpu.cli import config as jconfig
    from cxrmate_tpu.cli import stages as jstages
    from cxrmate_tpu.data.pipeline import batch_iterator as jbatches

    from cxrmate_torch.cli import config as tconfig
    from cxrmate_torch.cli import stages as tstages
    from cxrmate_torch.data.pipeline import batch_iterator
    from cxrmate_torch.data.synthetic import build_synthetic_dataset

    paths = build_synthetic_dataset(str(tmp_path), n_train=3, n_val=1, n_test=1,
                                    studies_per_subject=1, image_hw=(140, 131))
    src = glob.glob(os.path.join(paths["dataset_dir"], "**", "*.jpg"), recursive=True)[0]
    assert native.pick_scale_denom(open(src, "rb").read(), 32) == 4
    kw = dict(dataset_dir=paths["dataset_dir"], ckpt_zoo_dir=paths["ckpt_zoo_dir"],
              exp_dir=str(tmp_path / "exp"), variant="multi", model_preset="tiny",
              image_size=32, max_images_per_study=2, mbatch_size=2, image_cache_dir=None)
    got = tstages.make_datasets(tconfig.TaskConfig(device="cpu", **kw), "train", True)
    want = jstages.make_datasets(jconfig.TaskConfig(**kw), "train", True)
    for ds in (got, want):
        ds.load_image.set_epoch(1)
    a = next(iter(batch_iterator(got, 3)))
    b = next(iter(jbatches(want, 3)))
    assert list(a) == list(b)
    assert a["images"].shape == (3, 1, 3, 32, 32)
    np.testing.assert_array_equal(a["images"], b["images"])
