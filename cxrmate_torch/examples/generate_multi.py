"""Multi-image (per-study) report generation (the cxrmate-multi-tf flow), on the card.

    python -m cxrmate_torch.examples.generate_multi --checkpoint DIR \
        --images a.jpg b.jpg [--num-beams 4] [--device cuda]

The port of ``examples/generate_multi.py``: all images are of ONE study,
stacked on the image axis.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from cxrmate_torch.data.image import eval_transform, load_image
from cxrmate_torch.examples.generate_single import IMAGE_SIZE, parser
from cxrmate_torch.models.api import CXRMate


def generate(checkpoint: str, images: Sequence[str], num_beams: int = 4, device: str = "cuda",
             image_size: int = IMAGE_SIZE,
             max_new_tokens: Optional[int] = None) -> Tuple[List[str], List[str]]:
    """The study's report, printed; ``max_new_tokens`` defaults to the
    model's decoder_max_len - 1."""
    model = CXRMate.from_hf_checkpoint(checkpoint, variant="multi", device=device)
    study = np.stack([eval_transform(load_image(p), image_size) for p in images])
    findings, impression = model.generate_report(study[None], num_beams=num_beams,
                                                 max_new_tokens=max_new_tokens)
    print(f"Findings: {findings[0]}\nImpression: {impression[0]}")
    return findings, impression


def main(argv: Optional[List[str]] = None) -> Tuple[List[str], List[str]]:
    args = parser(__doc__.split("\n")[0], "HF checkpoint dir (aehrc/cxrmate-multi-tf)",
                  "JPEGs of ONE study").parse_args(argv)
    return generate(**vars(args))


if __name__ == "__main__":
    main()
