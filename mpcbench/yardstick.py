"""The benchmark's yardstick for the kernels: the card's peaks, the bytes
each kernel must move (from shapes: each input read once, each output
written once) and the operations it must do (counted).

The peaks are NVIDIA's data sheet for one H100 SXM at its 700 W limit:
3.35 TB/s of HBM and 67 TFLOP/s in float32 outside the tensor cores. A
kernel's bound is the larger of its bytes over the memory rate and its
operations over the f32 rate.

The operations are counted by ``opcount/op_count.cpp``: it builds the
kernels' ``__host__ __device__`` bodies (``opcount/ip_solve.cu``,
``riccati.cu``, ``irk_step.cu``, frozen copies of the program's K1, K2 and
K3) with a number type that records one scenario's computation, and counts
the distinct operations its outputs need (the file's header says what
counts). The copies are frozen so that a later rewrite of a kernel does not
change its own yardstick. The counter is built with the host's C++
compiler into ``.mpcbench_cache/`` inside the checkout, once per source.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

import numpy as np

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
HERE = os.path.dirname(os.path.abspath(__file__))
OPCOUNT_DIR = os.path.join(HERE, "opcount")
CACHE_DIR = os.path.join(os.path.dirname(HERE), ".mpcbench_cache")
# K1's float32 constants: tau, tol, stat_tol, sigma_max, and reg at the
# batched tick's default
K1_TAU, K1_TOL, K1_STAT_TOL, K1_SIGMA_MAX, K1_REG = 0.99, 1e-7, 1e-4, 1e7, 1e-6
QP_FIELDS = ("A", "B", "c", "dx0", "Q", "q", "R", "r", "S", "lb_u", "ub_u", "lb_x",
             "ub_x", "C", "hval", "zl", "Zl")


def bound_s(nbytes: float, ops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)


def k1_bytes(rows: int, N: int, M: int) -> int:
    """K1's unicycle instantiation: the QP entries it reads (diagonal Q and
    R, no S, the x/y columns of C, A without its unit columns), once, and
    dx, du, s, mu, stat written once; float32."""
    n1 = N + 1
    ins = (N * 5 * 3 + N * 10 + N * 5 + 5 + n1 * 5 + n1 * 5 + N * 2 + N * 2
           + N * 4 + n1 * 8 + n1 * M * 2 + n1 * M * 2)
    outs = n1 * 5 + N * 2 + n1 * M + 2
    return 4 * rows * (ins + outs)


def k3_bytes(rows: int, stages: int, sensitivities: bool, itemsize: int = 4) -> int:
    """K3, one IRK step of ``rows`` rows: x and u read once, Phi (and D,
    5 x 7 a row) written once, and the tableau."""
    per_row = 5 + 2 + 5 + (35 if sensitivities else 0)
    return itemsize * (rows * per_row + stages * stages + stages)


def _source_hash() -> str:
    h = hashlib.sha256()
    for name in sorted(os.listdir(OPCOUNT_DIR)):
        with open(os.path.join(OPCOUNT_DIR, name), "rb") as f:
            h.update(name.encode() + f.read())
    return h.hexdigest()[:16]


class OpCounter:
    """The host build of ``opcount/op_count.cpp``."""

    def __init__(self):
        os.makedirs(CACHE_DIR, exist_ok=True)
        lib = os.path.join(CACHE_DIR, f"libop_count_{_source_hash()}.so")
        if not os.path.exists(lib):
            cxx = shutil.which("g++") or shutil.which("c++")
            if cxx is None:
                raise RuntimeError("no host C++ compiler for the operation counter")
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=CACHE_DIR)
            os.close(fd)
            subprocess.run([cxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-pthread", "-o", tmp,
                            os.path.join(OPCOUNT_DIR, "op_count.cpp")],
                           check=True, capture_output=True, timeout=600)
            os.replace(tmp, lib)
        self._lib = ctypes.CDLL(lib)
        self._lib.count_ip_solve.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 4
                                             + [ctypes.c_double] * 5 + [ctypes.c_int])
        self._lib.count_ip_solve.restype = ctypes.c_longlong
        self._lib.count_riccati.argtypes = [ctypes.c_int]
        self._lib.count_riccati.restype = ctypes.c_longlong
        self._lib.count_irk_step.argtypes = [ctypes.c_int] * 4
        self._lib.count_irk_step.restype = ctypes.c_longlong

    def k1(self, qp: dict, iters: int) -> int:
        """K1's operations (unicycle instantiation) on a batch of QPs given
        as cost-normalized float64 numpy arrays by field name: the sum over
        the rows of what each one's solve needs."""
        host = [np.ascontiguousarray(qp[k], dtype=np.float64) for k in QP_FIELDS]
        nb, N, M = host[0].shape[0], host[0].shape[1], host[13].shape[-2]
        ptrs = (ctypes.c_void_p * 17)(*[a.ctypes.data for a in host])
        return self._lib.count_ip_solve(ptrs, nb, N, M, int(iters), K1_REG, K1_TAU, K1_TOL,
                                        K1_STAT_TOL, K1_SIGMA_MAX, 1)

    def k2(self, N: int) -> int:
        """K2's operations on one LQR of horizon ``N`` (data independent)."""
        return self._lib.count_riccati(N)

    def k3(self, rows: int, stages: int, newton_iter: int, sensitivities: bool) -> int:
        """K3's operations on a launch of ``rows`` rows (one substep): each
        row's, and the tableau's s^2 products, which a launch needs once."""
        per_row = self._lib.count_irk_step(stages, newton_iter, 1, int(sensitivities))
        if per_row < 0:
            raise ValueError(f"K3 has no instantiation for s = {stages}")
        return rows * per_row + stages * stages
