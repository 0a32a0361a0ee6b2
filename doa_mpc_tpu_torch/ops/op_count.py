"""Operation counts of kernels K1, K2 and K3, for their bounds.

``csrc/op_count.cpp`` builds each kernel's body on the host with a number
type that records one scenario's (K3: one row's) computation and counts the
operations its outputs need, each distinct operation once (the file's
header says exactly what counts). This module builds it with g++ and calls it; ``chip_smoke.py``
divides the counts by the card's f32 rate for each kernel's ``bound_ms``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile

import torch

from doa_mpc_tpu_torch.ops import cuda_build
from doa_mpc_tpu_torch.ops.ip_fused import _constants, structure_id
from doa_mpc_tpu_torch.ops.ocp_qp import OcpQp, normalize_cost

SOURCE = os.path.join(cuda_build.CSRC_DIR, "op_count.cpp")


class OpCounter:
    """The g++ build of ``csrc/op_count.cpp`` (with the kernel sources it
    includes), compiled anew into ``out_dir/libop_count.so``."""

    def __init__(self, out_dir: str = cuda_build.BUILD_DIR):
        cxx = shutil.which("g++") or shutil.which("c++")
        if cxx is None:
            raise RuntimeError("no host C++ compiler for the op counter")
        os.makedirs(out_dir, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        subprocess.run([cxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-pthread",
                        "-o", tmp, SOURCE], check=True, capture_output=True, timeout=600)
        lib = os.path.join(out_dir, "libop_count.so")
        os.replace(tmp, lib)
        self._lib = ctypes.CDLL(lib)
        self._lib.count_ip_solve.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 4
                                             + [ctypes.c_double] * 5 + [ctypes.c_int])
        self._lib.count_ip_solve.restype = ctypes.c_longlong
        self._lib.count_riccati.argtypes = [ctypes.c_int]
        self._lib.count_riccati.restype = ctypes.c_longlong
        self._lib.count_irk_step.argtypes = [ctypes.c_int] * 4
        self._lib.count_irk_step.restype = ctypes.c_longlong

    def ip_solve(self, qp: OcpQp, iters: int, structure=None, tol: float | None = None,
                 stat_tol: float | None = None) -> int:
        """K1's operations on the batch ``qp`` (any device; run in float64 on
        the host) with the float32 kernel's constants (``tau`` 0.99, as the
        main path runs it): the sum over the scenarios of what each one's
        solve needs."""
        tol0, reg, sigma_max, stat_tol0 = _constants(torch.float32, None, tol)
        qn, _ = normalize_cost(OcpQp(*[a.double().cpu() for a in qp]))
        host = [a.contiguous() for a in qn]
        nb, N, M = qp.A.shape[0], qp.A.shape[1], qp.C.shape[-2]
        ptrs = (ctypes.c_void_p * 17)(*[a.data_ptr() for a in host])
        return self._lib.count_ip_solve(ptrs, nb, N, M, int(iters), reg, 0.99, tol0,
                                        stat_tol0 if stat_tol is None else stat_tol,
                                        sigma_max, structure_id(structure))

    def riccati(self, N: int) -> int:
        """K2's operations on one LQR of horizon ``N``; its work does not
        depend on the data."""
        return self._lib.count_riccati(N)

    def irk_step(self, rows: int, stages: int, newton_iter: int, num_steps: int,
                 sensitivities: bool) -> int:
        """K3's operations on a launch of ``rows`` rows: ``rows`` times one
        row's (its work does not depend on the data), and the tableau's
        s^2 products (-h) A, which the launch needs once."""
        per_row = self._lib.count_irk_step(stages, newton_iter, num_steps, int(sensitivities))
        if per_row < 0:
            raise ValueError(f"K3 has no instantiation for s = {stages}, newton_iter = "
                             f"{newton_iter}, num_steps = {num_steps}")
        return rows * per_row + stages * stages
