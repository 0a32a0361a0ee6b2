"""Batched Riccati factorize + solve: kernel K2 and its plain version.

The counterpart of ``doa_mpc_tpu/ops/riccati_pallas.py``. One call runs the
backward factorization, the backward gradient pass, the forward rollout and
the costate for a batch of LQR problems (nu = 2).

- :func:`riccati_solve_fused` is the wrapper. On CUDA tensors it launches the
  hand-written kernel ``csrc/riccati.cu`` (built with nvcc for ``sm_90a`` at
  first use, bound with ctypes; float32 and float64 entry points) and counts
  the launch in ``riccati_solve_fused.launches``. On CPU tensors, and only
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

def build_kernel() -> str:
    """Compile ``csrc/riccati.cu`` into ``_build/`` at first use
    (:func:`cuda_build.build`); returns the library path."""
    return cuda_build.build(KERNEL_SOURCE)


@functools.lru_cache(maxsize=None)
def _library():
    lib = ctypes.CDLL(build_kernel())
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.riccati_f32.argtypes = [ptr] * 13 + [i32, i32, ctypes.c_float, ptr]
    lib.riccati_f64.argtypes = [ptr] * 13 + [i32, i32, ctypes.c_double, ptr]
    lib.riccati_f32.restype = lib.riccati_f64.restype = i32
    lib.riccati_work_values.argtypes = [i32]
    lib.riccati_work_values.restype = ctypes.c_longlong
    lib.riccati_error_string.argtypes = [i32]
    lib.riccati_error_string.restype = ctypes.c_char_p
    return lib


def _check_cuda_inputs(args: dict) -> None:
    """Raise on what the kernel does not take: mixed devices or dtypes, a
    dtype other than float32/float64, nx != 5, nu != 2 or mismatched shapes."""
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


def _batch_last(a: torch.Tensor, stages: int) -> torch.Tensor:
    """(B, stages, ...) -> (stages, flattened stage block, B), contiguous."""
    return a.reshape(a.shape[0], stages, -1).permute(1, 2, 0).contiguous()


def riccati_solve_fused(Q, R, S, A, B, q, r, d, x0, reg: float = 1e-8):
    """Batched fused Riccati solve (batch-first interface).

    Q (Bt, N+1, nx, nx), R (Bt, N, nu, nu), S (Bt, N, nu, nx),
    A (Bt, N, nx, nx), B (Bt, N, nx, nu), q (Bt, N+1, nx), r (Bt, N, nu),
    d (Bt, N, nx), x0 (Bt, nx)
    -> (x (Bt, N+1, nx), u (Bt, N, nu), nu_dyn (Bt, N, nx)).

    CPU tensors run :func:`riccati_solve_fused_ref`. CUDA tensors (float32 or
    float64, nx = 5, nu = 2) launch the kernel once and add one to
    ``riccati_solve_fused.launches``; anything else raises."""
    dev = A.device
    if dev.type == "cpu":
        return riccati_solve_fused_ref(Q, R, S, A, B, q, r, d, x0, reg=reg)
    if dev.type != "cuda":
        raise ValueError(f"riccati_solve_fused: unsupported device {dev}")
    args = dict(Q=Q, R=R, S=S, A=A, B=B, q=q, r=r, d=d, x0=x0)
    _check_cuda_inputs(args)
    nb, N, dtype = A.shape[0], A.shape[1], A.dtype
    packed = [_batch_last(Q, N + 1), _batch_last(R, N), _batch_last(S, N),
              _batch_last(A, N), _batch_last(B, N), _batch_last(q, N + 1),
              _batch_last(r, N), _batch_last(d, N), _batch_last(x0, 1)]
    lib = _library()
    kw = dict(dtype=dtype, device=dev)
    dx = torch.empty((N + 1, NX, nb), **kw)
    du = torch.empty((N, NU, nb), **kw)
    nu = torch.empty((N, NX, nb), **kw)
    work = torch.empty((lib.riccati_work_values(N) * nb,), **kw)
    launch = lib.riccati_f32 if dtype == torch.float32 else lib.riccati_f64
    with torch.cuda.device(dev):      # launch on the card that holds the data
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = launch(*[a.data_ptr() for a in packed + [dx, du, nu, work]],
                    nb, N, float(reg), stream)
    if rc != 0:
        raise RuntimeError("riccati launch failed: " + lib.riccati_error_string(rc).decode())
    riccati_solve_fused.launches += 1
    return dx.permute(2, 0, 1), du.permute(2, 0, 1), nu.permute(2, 0, 1)


riccati_solve_fused.launches = 0
