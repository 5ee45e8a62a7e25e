"""Building the port's host C++ libraries (the JPEG codec, the BPE encoder).

Each library is compiled at first use by the host C++ compiler (``$CXX``,
``g++`` or ``c++``) into ``cxrmate_torch/_build/<name>-<hash>/``, keyed by a
hash of its sources and flags, under a file lock, as ``ops/_build.py``
builds the kernels. No compiler raises, and a failed compile raises with the
compiler's output; nothing falls back.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Sequence

BUILD_ROOT = Path(__file__).resolve().parents[1] / "_build"


def cxx() -> str:
    for c in (os.environ.get("CXX"), shutil.which("g++"), shutil.which("c++")):
        if c and (os.path.exists(c) or shutil.which(c)):
            return c
    raise RuntimeError("no C++ compiler for the port's host libraries (looked for $CXX, g++, c++)")


def build_library(name: str, source: Path, lib_name: str, flags: Sequence[str],
                  headers: Sequence[Path] = ()) -> Path:
    """Path of ``lib_name`` built from ``source`` (including ``headers``,
    which go into the hash), compiling it first if this hash has not been
    built."""
    h = hashlib.sha256(" ".join(flags).encode())
    for f in (source, *headers):
        h.update(Path(f).read_bytes())
    out_dir = BUILD_ROOT / f"{name}-{h.hexdigest()[:16]}"
    so = out_dir / lib_name
    if so.exists():
        return so
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if so.exists():
            return so
        tmp = out_dir / (lib_name + ".tmp")
        res = subprocess.run([cxx(), *flags, str(source), "-o", str(tmp)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"building {Path(source).name} failed:\n{res.stdout}")
        os.replace(tmp, so)
    return so
