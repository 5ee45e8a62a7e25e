"""SPICE adapter: semantic propositional image caption evaluation.

The port's own copy of ``cxrmate_tpu/eval/spice.py``. The reference scores
SPICE through pycocoevalcap's bundled Java pipeline (its
``tools/metrics/coco.py:7,65``: spice-1.0.jar + the Stanford CoreNLP
dependency parser + WordNet). There is no pure-Python equivalent of the
scene-graph parser, and the jars and models are not redistributable, so SPICE
is an *adapter*: point ``CXRMATE_SPICE_JAR`` (and a working ``java``) at a
pycocoevalcap installation to enable it; otherwise requesting the metric
fails loudly with instructions.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import tempfile
from typing import Dict, List, Tuple


def spice_available() -> bool:
    jar = os.environ.get("CXRMATE_SPICE_JAR")
    return bool(jar and os.path.exists(jar) and shutil.which("java"))


def spice(gts: Dict, res: Dict) -> Tuple[float, List[float]]:
    """pycocoevalcap-style interface: gts/res are {id: [tokenised string, ...]};
    returns (corpus mean F-score, per-item F-scores)."""
    jar = os.environ.get("CXRMATE_SPICE_JAR")
    if not jar or not os.path.exists(jar):
        raise RuntimeError(
            "SPICE requires the pycocoevalcap spice-1.0.jar (Java + Stanford "
            "CoreNLP models). Set CXRMATE_SPICE_JAR=/path/to/spice-1.0.jar to "
            "enable it; it is not bundled because the jar and its models cannot "
            "ship with the package. All other NLG metrics run natively."
        )
    if not shutil.which("java"):
        raise RuntimeError("SPICE needs a java runtime on PATH (jar found, java missing).")

    # the jar's batch JSON protocol (pycocoevalcap/spice/spice.py)
    inputs = [
        {"image_id": k, "test": res[k][0], "refs": list(gts[k])} for k in gts
    ]
    with tempfile.TemporaryDirectory() as tmp:
        in_path = os.path.join(tmp, "in.json")
        out_path = os.path.join(tmp, "out.json")
        with open(in_path, "w") as f:
            json.dump(inputs, f)
        subprocess.check_call(
            ["java", "-jar", "-Xmx8G", jar, in_path, "-cache", os.path.join(tmp, "cache"),
             "-out", out_path, "-subset", "-silent"],
            cwd=os.path.dirname(os.path.abspath(jar)),
        )
        with open(out_path) as f:
            results = json.load(f)
    by_id = {r["image_id"]: float(r["scores"]["All"]["f"]) for r in results}
    per_item = [by_id[k] for k in gts]
    return (sum(per_item) / len(per_item) if per_item else 0.0), per_item
