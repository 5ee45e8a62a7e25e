"""Single-image report generation (the cxrmate-single-tf flow), on the card.

    python -m cxrmate_torch.examples.generate_single --checkpoint DIR \
        --images a.jpg b.jpg [--num-beams 4] [--device cuda]

The port of ``examples/generate_single.py``: ``--checkpoint`` is a local copy
of the released HF checkpoint directory (config + weights + tokenizer.json);
each image is its own study. ``--device`` is "cuda" unless asked otherwise,
with no fallback to the CPU.
"""

from __future__ import annotations

import argparse
from typing import List, Optional, Sequence, Tuple

import numpy as np

from cxrmate_torch.data.image import eval_transform, load_image
from cxrmate_torch.models.api import CXRMate

IMAGE_SIZE = 384  # the released checkpoints' training size


def parser(description: str, checkpoint_help: str, images_help: str) -> argparse.ArgumentParser:
    """The options the three generate examples share."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--checkpoint", required=True, help=checkpoint_help)
    p.add_argument("--images", nargs="+", required=True, help=images_help)
    p.add_argument("--num-beams", type=int, default=4)
    p.add_argument("--device", default="cuda", help="torch device (default cuda; no fallback)")
    return p


def generate(checkpoint: str, images: Sequence[str], num_beams: int = 4, device: str = "cuda",
             image_size: int = IMAGE_SIZE,
             max_new_tokens: Optional[int] = None) -> Tuple[List[str], List[str]]:
    """One report per image, printed under its path; ``max_new_tokens``
    defaults to the model's decoder_max_len - 1."""
    model = CXRMate.from_hf_checkpoint(checkpoint, variant="single", device=device)
    pixels = np.stack([eval_transform(load_image(p), image_size) for p in images])
    findings, impression = model.generate_report(pixels, num_beams=num_beams,
                                                 max_new_tokens=max_new_tokens)
    for path, f, i in zip(images, findings, impression):
        print(f"== {path}\nFindings: {f}\nImpression: {i}\n")
    return findings, impression


def main(argv: Optional[List[str]] = None) -> Tuple[List[str], List[str]]:
    args = parser(__doc__.split("\n")[0], "HF checkpoint dir (aehrc/cxrmate-single-tf)",
                  "chest X-ray JPEG paths").parse_args(argv)
    return generate(**vars(args))


if __name__ == "__main__":
    main()
