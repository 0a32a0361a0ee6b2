"""Build the port's CUDA sources into shared libraries at first use.

Each source under ``csrc/`` has a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into ``_build/lib<stem>_<hash>.so``, where the hash
covers the source and the flags: one library per source hash, rebuilt only
when either changes. The wrappers bind the library with ctypes. Nothing here
runs at import time, so the CPU tests import every module without ``nvcc``.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def source_hash(source: str) -> str:
    h = hashlib.sha256()
    with open(source, "rb") as f:
        h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernel cannot be built")


def build(source: str) -> str:
    """Compile ``source`` into ``_build/`` unless a library built from the
    same source and flags is there. Returns the library path; the compiler's
    ``-Xptxas -v`` report is kept beside it (``.log``). Safe to call for
    several sources at once from threads: each build writes its own
    temporary file and renames it into place."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    stem = os.path.splitext(os.path.basename(source))[0]
    lib = os.path.join(BUILD_DIR, f"lib{stem}_{source_hash(source)}.so")
    if os.path.exists(lib):
        return lib
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, source]
    res = subprocess.run(cmd, capture_output=True, text=True)
    with open(lib[:-3] + ".log", "w") as f:
        f.write(" ".join(cmd) + "\n" + res.stdout + res.stderr)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on {source} ({res.returncode}):\n"
                           f"{res.stderr[-4000:]}")
    os.replace(tmp, lib)
    return lib


def ptxas_report(lib: str) -> list[str]:
    """The function/registers/spill lines of the build log kept beside
    ``lib``."""
    keys = ("Function properties for", "registers", "spill")
    with open(lib[:-3] + ".log") as f:
        return [ln.strip().removeprefix("ptxas info    : ") for ln in f
                if any(k in ln for k in keys)]
