"""Write the JPEG fixtures that hold the port's decoder to PIL where PIL is absent.

    python -m cxrmate_torch.tools.make_jpeg_fixtures     # needs PIL

Writes a handful of small JPEGs saved by PIL (gray, YCbCr 4:2:0, 4:2:2 and
4:4:4, odd sizes, qualities 75 and 95, one with restart markers) and the
pixels PIL decodes from each (``<name>.npy``) into
``cxrmate_torch/tools/jpeg_fixtures/``. ``tests/test_torch_image.py::
test_codec_matches_pil_fixtures`` and ``chip_smoke.py``'s ``data`` phase
decode them with the port's codec on a machine without PIL and require the
same pixels, bit for bit.
"""

from __future__ import annotations

import io
import os

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


def main() -> None:
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
