"""Build the port's CUDA sources into shared libraries at first use, and the
load-and-launch path the kernels' wrappers share.

Each source under ``csrc/`` has a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into ``_build/lib<stem>_<hash>.so``, where the hash
covers the source and the flags: one library per source hash, rebuilt only
when either changes. A wrapper loads its library once (:func:`load`), makes
the launch :class:`Plan` of each card and shape once (:func:`plan`) and then
only launches (:func:`launch`). A source's entry points share a prefix
(``ip_solve_``, ``riccati_``, ``irk_step_``), and ``<prefix>_error_string``
turns a nonzero return into text (:func:`check`). Nothing here runs at import
time, so the CPU tests import every module without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import NamedTuple

import torch

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


class Plan(NamedTuple):
    """How a kernel's launches of one shape run on one card, as its C entry
    ``<prefix>_plan`` works them out. The entry raises the kernel's
    shared-memory limit to what the plan needs and never lowers it, so a
    plan stays valid once made: a wrapper makes it once per card and shape,
    and a launch makes no device query."""
    blocks: int        # the grid
    bytes: int         # dynamic shared memory per block
    per: int           # values of one scenario's arrays, on chip or in the workspace
    work: int          # values of device-memory workspace; 0: the arrays are on chip
    resident: int      # scenarios resident per SM (occupancy API)


def declare(lib, prefix: str, entries: dict):
    """Declare the entry points of a loaded library: ``entries`` maps each
    name after ``prefix`` to its (restype, argtypes); ``<prefix>_error_string``
    is declared too. Returns ``lib``."""
    entries = {**entries, "error_string": (ctypes.c_char_p, [ctypes.c_int])}
    for name, (res, args) in entries.items():
        fn = getattr(lib, f"{prefix}_{name}")
        fn.restype, fn.argtypes = res, args
    return lib


def load(source: str, prefix: str, entries: dict):
    """Build ``source`` (:func:`build`), load the library and declare its
    entry points (:func:`declare`)."""
    return declare(ctypes.CDLL(build(source)), prefix, entries)


def check(lib, prefix: str, rc: int, what: str) -> None:
    """Raise a RuntimeError for a nonzero return ``rc`` of an entry point of
    ``lib``: ``what``, then the library's own error string."""
    if rc != 0:
        raise RuntimeError(f"{what}: " + getattr(lib, f"{prefix}_error_string")(rc).decode())


def plan(lib, prefix: str, device: int, *args) -> Plan:
    """``<prefix>_plan(*args, out)`` on card ``device``: the :class:`Plan`
    of a launch."""
    out = (ctypes.c_longlong * len(Plan._fields))()
    with torch.cuda.device(device):
        rc = getattr(lib, f"{prefix}_plan")(*args, out)
    check(lib, prefix, rc, f"{prefix}_plan{args} failed")
    return Plan(*out)


def launch(lib, prefix: str, entry: str, device: torch.device, *args, what: str) -> None:
    """``<prefix>_<entry>(*args, stream)`` on the card that holds the data,
    on its current stream; a nonzero return raises (:func:`check`, with
    ``what``)."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, f"{prefix}_{entry}")(*args, stream)
    check(lib, prefix, rc, what)
