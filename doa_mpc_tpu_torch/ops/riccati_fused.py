"""Batched Riccati factorize + solve: kernel K2 and its plain version.

The counterpart of ``doa_mpc_tpu/ops/riccati_pallas.py``. One call runs the
backward factorization, the backward gradient pass, the forward rollout and
the costate for a batch of LQR problems (nu = 2).

- :func:`riccati_solve_fused` is the wrapper. On CUDA tensors it launches the
  hand-written kernel ``csrc/riccati.cu`` (built with nvcc for ``sm_90a`` at
  first use, bound with ctypes; float32 and float64 entry points) on the
  contiguous batch-first inputs in place, and counts the launch in
  ``riccati_solve_fused.launches``. On CPU tensors, and only
  then, it runs the plain version. There is no fallback from the kernel to
  the plain version.
- :func:`riccati_solve_fused_ref` is the plain PyTorch version. It follows
  the TPU kernel's formulas, not ``ops/riccati.py``'s: ``P_N = Q_N`` and
  ``Huu = R + B'PB`` are not symmetrized; the 2x2 Cholesky adds ``reg`` to
  both diagonal entries, reads ``Huu[1][0]`` and floors ``l22^2`` at 1e-30;
  K and kff come from the 2x2 triangular solves; P is symmetrized after its
  update; the costate comes from the stored P_{k+1} and p_{k+1}.
"""

from __future__ import annotations

import ctypes
import functools
import os

import torch

from doa_mpc_tpu_torch.ops import cuda_build

KERNEL_SOURCE = os.path.join(cuda_build.CSRC_DIR, "riccati.cu")
NX, NU = 5, 2


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------

def _mv(A, x):
    return (A @ x.unsqueeze(-1)).squeeze(-1)


def _chol2(H, reg):
    """Cholesky of a batched 2x2 matrix (B, 2, 2) -> (l11, l21, l22)."""
    l11 = torch.sqrt(H[:, 0, 0] + reg)
    l21 = H[:, 1, 0] / l11
    l22 = torch.sqrt(torch.clamp_min(H[:, 1, 1] + reg - l21 * l21, 1e-30))
    return l11, l21, l22


def _chol2_solve(L, b):
    """Solve (L L') x = b for b (B, 2) or (B, 2, cols)."""
    l11, l21, l22 = (l.reshape(l.shape + (1,) * (b.ndim - 2)) for l in L)
    y1 = b[:, 0] / l11
    y2 = (b[:, 1] - l21 * y1) / l22
    x2 = y2 / l22
    x1 = (y1 - l21 * x2) / l11
    return torch.stack([x1, x2], 1)


def riccati_solve_fused_ref(Q, R, S, A, B, q, r, d, x0, reg: float = 1e-8):
    """Plain PyTorch version of kernel K2 (module docstring lists the
    formulas it shares with the kernel and not with ``ops/riccati.py``).
    Arguments and returns as :func:`riccati_solve_fused`."""
    N = A.shape[1]
    if B.shape[-1] != NU:
        raise ValueError(f"kernel K2 is written for nu = {NU}; got nu = {B.shape[-1]}")
    P, p = Q[:, N], q[:, N]
    Ps, pns, Ks, kffs = [None] * N, [None] * N, [None] * N, [None] * N
    for k in reversed(range(N)):
        Ps[k], pns[k] = P, p                               # P_{k+1}, p_{k+1}
        Ak, Bk = A[:, k], B[:, k]
        PA = P @ Ak
        L = _chol2(R[:, k] + Bk.mT @ (P @ Bk), reg)
        Hux = S[:, k] + Bk.mT @ PA
        Ks[k] = -_chol2_solve(L, Hux)
        Pd_p = _mv(P, d[:, k]) + p
        m = r[:, k] + _mv(Bk.mT, Pd_p)
        kffs[k] = -_chol2_solve(L, m)
        Pk = Q[:, k] + (Ak.mT @ PA + Hux.mT @ Ks[k])
        P = 0.5 * (Pk + Pk.mT)
        p = q[:, k] + (_mv(Ak.mT, Pd_p) + _mv(Ks[k].mT, m))
    x, xs, us, nus = x0, [x0], [], []
    for k in range(N):
        u = _mv(Ks[k], x) + kffs[k]
        x = (_mv(A[:, k], x) + _mv(B[:, k], u)) + d[:, k]
        xs.append(x)
        us.append(u)
        nus.append(-(_mv(Ps[k], x) + pns[k]))
    return torch.stack(xs, 1), torch.stack(us, 1), torch.stack(nus, 1)


# ---------------------------------------------------------------------------
# the CUDA kernel: build, bind, launch
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _library():
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    return cuda_build.load(KERNEL_SOURCE, "riccati", {
        "f32": (i32, [ptr] * 13 + [i32, i32, ctypes.c_float, i64, i64, ptr]),
        "f64": (i32, [ptr] * 13 + [i32, i32, ctypes.c_double, i64, i64, ptr]),
        "plan": (i32, [i32] * 3 + [ctypes.POINTER(i64)]),
        "smem_bytes": (i64, [i32] * 2)})


@functools.lru_cache(maxsize=None)
def _plan(device: int, itemsize: int, nb: int, N: int) -> cuda_build.Plan:
    return cuda_build.plan(_library(), "riccati", device, itemsize, nb, N)


def plan(nb: int, N: int, dtype: torch.dtype = torch.float32) -> cuda_build.Plan:
    """How a launch of ``nb`` scenarios runs on the current card
    (``riccati_plan``, made once per card, dtype and shape): the grid cut to
    balanced waves; the scratch in shared memory when a block holds its
    scenarios', else in a device-memory workspace of one slice per tile,
    which the wrapper allocates."""
    return _plan(torch.cuda.current_device(), dtype.itemsize, nb, N)


def smem_bytes(N: int, dtype: torch.dtype = torch.float32) -> int:
    """Shared memory that one block of the kernel (one warp: two scenarios,
    each a team of 16 lanes) needs to hold its scenarios' stage ring, exchange buffers and
    scratch on chip, as ``csrc/riccati.cu`` sizes them."""
    return _library().riccati_smem_bytes(dtype.itemsize, N)


def _check_cuda_inputs(args: dict) -> None:
    """Raise on what the kernel does not take: mixed devices or dtypes, a
    dtype other than float32/float64, nx != 5, nu != 2, mismatched shapes
    or, after those, an input that is not contiguous."""
    dev, dtype = args["A"].device, args["A"].dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"kernel K2 takes float32 or float64; A is {dtype}")
    for name, a in args.items():
        if a.device != dev:
            raise ValueError(f"{name} is on {a.device}, A on {dev}")
        if a.dtype != dtype:
            raise TypeError(f"{name} is {a.dtype}, A is {dtype}")
    nb, N = args["A"].shape[0], args["A"].shape[1]
    want = dict(Q=(nb, N + 1, NX, NX), R=(nb, N, NU, NU), S=(nb, N, NU, NX),
                A=(nb, N, NX, NX), B=(nb, N, NX, NU), q=(nb, N + 1, NX),
                r=(nb, N, NU), d=(nb, N, NX), x0=(nb, NX))
    if N < 1 or nb < 1:
        raise ValueError(f"kernel K2 needs N >= 1 and a batch >= 1; got N={N}, B={nb}")
    for name, shape in want.items():
        if tuple(args[name].shape) != shape:
            raise ValueError(f"{name} has shape {tuple(args[name].shape)}, expected {shape} "
                             f"(kernel K2 is built for nx={NX}, nu={NU})")
    for name, a in args.items():
        if not a.is_contiguous():
            raise ValueError(f"{name} is not contiguous: kernel K2 reads each scenario's "
                             "field as one batch-first run")


def riccati_solve_fused(Q, R, S, A, B, q, r, d, x0, reg: float = 1e-8):
    """Batched fused Riccati solve (batch-first interface).

    Q (Bt, N+1, nx, nx), R (Bt, N, nu, nu), S (Bt, N, nu, nx),
    A (Bt, N, nx, nx), B (Bt, N, nx, nu), q (Bt, N+1, nx), r (Bt, N, nu),
    d (Bt, N, nx), x0 (Bt, nx)
    -> (x (Bt, N+1, nx), u (Bt, N, nu), nu_dyn (Bt, N, nx)).

    CPU tensors run :func:`riccati_solve_fused_ref`. CUDA tensors (float32 or
    float64, nx = 5, nu = 2, contiguous) launch the kernel once, which reads
    them in place and writes contiguous outputs, and add one to
    ``riccati_solve_fused.launches``; anything else raises."""
    dev = A.device
    if dev.type == "cpu":
        return riccati_solve_fused_ref(Q, R, S, A, B, q, r, d, x0, reg=reg)
    if dev.type != "cuda":
        raise ValueError(f"riccati_solve_fused: unsupported device {dev}")
    ins = (Q, R, S, A, B, q, r, d, x0)
    _check_cuda_inputs(dict(zip(("Q", "R", "S", "A", "B", "q", "r", "d", "x0"), ins)))
    nb, N, dtype = A.shape[0], A.shape[1], A.dtype
    kw = dict(dtype=dtype, device=dev)
    dx = torch.empty((nb, N + 1, NX), **kw)
    du = torch.empty((nb, N, NU), **kw)
    nu = torch.empty((nb, N, NX), **kw)
    pl = _plan(dev.index, dtype.itemsize, nb, N)
    work = torch.empty((pl.work,), **kw) if pl.work else None
    cuda_build.launch(
        _library(), "riccati", "f32" if dtype == torch.float32 else "f64", dev,
        *[a.data_ptr() for a in ins + (dx, du, nu)], None if work is None else work.data_ptr(),
        nb, N, float(reg), pl.blocks, pl.bytes,
        what=f"riccati launch failed (N={N}, {pl.bytes} B of shared memory per block, "
             f"{pl.work} values of workspace)")
    riccati_solve_fused.launches += 1
    return dx, du, nu


riccati_solve_fused.launches = 0