"""Longitudinal report generation with a previous-report prompt, on the card.

    python -m cxrmate_torch.examples.generate_longitudinal --checkpoint DIR \
        --images a.jpg b.jpg [--previous-findings TEXT] [--previous-impression TEXT] \
        [--num-beams 4] [--device cuda]

The port of ``examples/generate_longitudinal.py`` (the aehrc/cxrmate
flow): the images are of ONE study; the previous study's findings and
impression (absent: no prior) form the prompt.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from cxrmate_torch.data.image import eval_transform, load_image
from cxrmate_torch.examples.generate_single import IMAGE_SIZE, parser
from cxrmate_torch.models.api import CXRMate


def generate(checkpoint: str, images: Sequence[str], previous_findings: Optional[str] = None,
             previous_impression: Optional[str] = None, num_beams: int = 4,
             device: str = "cuda", image_size: int = IMAGE_SIZE,
             max_new_tokens: Optional[int] = None) -> Tuple[List[str], List[str]]:
    """The study's report after the previous one's prompt, printed;
    ``max_new_tokens`` defaults to the model's decoder_max_len - 1."""
    model = CXRMate.from_hf_checkpoint(checkpoint, variant="longitudinal", device=device)
    study = np.stack([eval_transform(load_image(p), image_size) for p in images])
    findings, impression = model.generate_report(
        study[None], previous_findings=[previous_findings],
        previous_impression=[previous_impression], num_beams=num_beams,
        max_new_tokens=max_new_tokens)
    print(f"Findings: {findings[0]}\nImpression: {impression[0]}")
    return findings, impression


def main(argv: Optional[List[str]] = None) -> Tuple[List[str], List[str]]:
    p = parser(__doc__.split("\n")[0], "HF checkpoint dir (aehrc/cxrmate or aehrc/cxrmate-tf)",
               "JPEGs of ONE study")
    p.add_argument("--previous-findings", default=None)
    p.add_argument("--previous-impression", default=None)
    return generate(**vars(p.parse_args(argv)))


if __name__ == "__main__":
    main()
