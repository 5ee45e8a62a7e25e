"""Write the JPEG fixtures that hold the port's decoder to PIL where PIL is absent.

    python -m cxrmate_torch.tools.make_jpeg_fixtures            # needs PIL
    python -m cxrmate_torch.tools.make_jpeg_fixtures --routes   # the port's codec only

Writes a handful of small JPEGs saved by PIL (gray, YCbCr 4:2:0, 4:2:2 and
4:4:4, odd sizes, qualities 75 and 95, one with restart markers) and the
pixels PIL decodes from each (``<name>.npy``) into
``cxrmate_torch/tools/jpeg_fixtures/``. ``tests/test_torch_image.py::
test_codec_matches_pil_fixtures`` and ``chip_smoke.py``'s ``data`` phase
decode them with the port's codec on a machine without PIL and require the
same pixels, bit for bit.

``--routes`` writes, from the committed JPEGs and with the port's codec,
the training loaders' native routes (``<name>.<case>.npy``, see
``route_cases``): the DCT-scaled RGB decode at targets that reach denoms 2,
4 and 8, and the fused fast decode and resize in gray mode (a colour source
comes back RGB) at denoms 1 and 2 with JDCT_IFAST and with ISLOW.
``tests/test_torch_scaled_decode.py`` holds each file equal to
``cxrmate_tpu.data.native``'s output (libjpeg) on its JPEG, and
``chip_smoke.py``'s ``entry`` phase holds the port's codec to the files.
"""

from __future__ import annotations

import glob
import io
import os
import sys
from typing import Dict, List, Tuple

import numpy as np

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "jpeg_fixtures")

# name: (height, width, rgb, PIL save arguments)
FIXTURES = {
    "gray_37x53_q75": (37, 53, False, dict(quality=75)),
    "gray_97x61_q95": (97, 61, False, dict(quality=95)),
    "ycc420_37x53_q75": (37, 53, True, dict(quality=75, subsampling=2)),
    "ycc420_61x97_q95": (61, 97, True, dict(quality=95, subsampling=2)),
    "ycc422_53x37_q90": (53, 37, True, dict(quality=90, subsampling=1)),
    "ycc444_48x40_q75": (48, 40, True, dict(quality=75, subsampling=0)),
    "ycc420_45x66_q75_restart": (45, 66, True, dict(quality=75, restart_marker_blocks=2)),
    "gray_50x33_q75_restart": (50, 33, False, dict(quality=75, restart_marker_rows=1)),
}


def image(h: int, w: int, rgb: bool, seed: int) -> np.ndarray:
    """Band-limited content plus noise."""
    rs = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = 128 + 60 * np.sin(x / 7.0) * np.cos(y / 11.0) + 30 * np.sin((x + y) / 23.0)
    if rgb:
        base = np.stack([base, 255 - base, base * 0.5 + 40], -1)
    return np.clip(base + rs.normal(0, 12, base.shape), 0, 255).astype(np.uint8)


def route_cases(height: int, width: int) -> List[Tuple[str, str, Dict]]:
    """(case, function of ``data.native``, keyword arguments) of the route
    fixtures of a JPEG of that size; the function takes the path first."""
    s = min(height, width)
    cases = [(f"scaled{d}", "load_jpeg_scaled", dict(target_shortest=s // d)) for d in (2, 4, 8)]
    for t in (s - 5, s // 2):  # denom 1 (IFAST applies) and denom 2
        for fast in (True, False):
            cases.append((f"fast{t}_{'ifast' if fast else 'islow'}", "load_jpeg_resized",
                          dict(target_shortest=t, gray=True, fast_dct=fast)))
    return cases


def route_fixtures() -> List[Tuple[str, str, str, Dict]]:
    """(jpg path, npy path, function name, kwargs) of every route fixture."""
    out = []
    for jpg in sorted(glob.glob(os.path.join(OUT, "*.jpg"))):
        h, w = np.load(jpg[:-4] + ".npy", mmap_mode="r").shape[:2]
        for case, fn, kw in route_cases(h, w):
            out.append((jpg, f"{jpg[:-4]}.{case}.npy", fn, kw))
    return out


def write_routes() -> None:
    from cxrmate_torch.data import native

    for jpg, npy, fn, kw in route_fixtures():
        np.save(npy, getattr(native, fn)(jpg, **kw))
    print(len(route_fixtures()), "route fixtures")


def main() -> None:
    if "--routes" in sys.argv[1:]:
        return write_routes()
    from PIL import Image

    os.makedirs(OUT, exist_ok=True)
    for seed, (name, (h, w, rgb, kw)) in enumerate(sorted(FIXTURES.items())):
        buf = io.BytesIO()
        Image.fromarray(image(h, w, rgb, seed)).save(buf, "JPEG", **kw)
        data = buf.getvalue()
        with open(os.path.join(OUT, name + ".jpg"), "wb") as f:
            f.write(data)
        np.save(os.path.join(OUT, name + ".npy"), np.asarray(Image.open(io.BytesIO(data))))
        print(name, len(data), "bytes")


if __name__ == "__main__":
    main()
