"""Whole-solve interior-point QP solver: kernel K1 and its plain version.

The counterpart of ``doa_mpc_tpu/ops/ip_pallas.py``. One call runs the
initialization and every Mehrotra predictor-corrector iteration for a batch
of soft-constrained OCP QPs (``ops/ocp_qp.OcpQp``, batch-first).

- :func:`solve_ocp_qp_fused` is the wrapper. On CUDA tensors it launches the
  hand-written kernel ``csrc/ip_solve.cu`` (built with nvcc for ``sm_90a`` at
  first use, bound with ctypes) and counts the launch in
  ``solve_ocp_qp_fused.launches``. On CPU tensors, and only then, it runs the
  plain version. There is no fallback from the kernel to the plain version.
  The kernel reads the fields batch-first as they come and writes dx, du, s
  batch-first; ``structure`` picks its instantiation (generic or unicycle).
  A row leaves the iteration loop once it is frozen, and a tile takes its
  next row from a counter the wrapper allocates for the launch. The grid,
  shared memory and workspace come from a plan made once per card and shape
  (:func:`plan`).
  While a ``torch.profiler`` records, the kernel also writes two counts per
  row, and the wrapper keeps them (``utils.profiling.kept``):
  ``k1.iters``, the iterations that updated the row (a converged row keeps
  its iterate, so that is the iterations the row needed), and ``k1.end``,
  the iterations its tile had run in the launch when the row was done, the
  row's own included (the largest is the launch's length in iterations).
  Otherwise the kernel gets null pointers and counts nothing.
- ``skip``, an optional (B,) bool mask on the QP's device, marks rows whose
  answer the caller discards (the batched tick passes its ``done`` rows,
  which it freezes). A marked row runs no iteration: its dx, du, s, mu and
  stat are zeros and its count of iterations 0, and the kernel's tile takes
  the next row at once. Unmarked rows are solved as without the mask, bit
  for bit. While a profiler records, the kernel counts the rows it skipped
  into one int, kept as ``k1.skipped``.
- :func:`solve_ocp_qp_fused_ref` is the plain PyTorch version. It follows the
  fused kernel's formulas, not ``ip_qp``'s: no ``sigma_retry``; the
  fraction-to-boundary step is ``min(1, tau * min ratio)`` with the 2.0
  sentinel; ``mu_aff`` is accumulated as ``sum(t l) + ap S1 + ad S2 +
  ap ad S3``; all residuals come from the pre-update iterate; ``mu`` and
  ``stat`` are those of the last iteration's pre-update iterate; the k = 0
  row of the stationarity residual is kept but left out of ``stat``;
  ``P_N = Qbar(N)``; the Cholesky of Huu adds ``reg`` and floors at 1e-30.
  Stage-serial recursions are Python loops over stages; stage-local work is
  batched over scenarios and stages. It counts and keeps each row's
  iterations (``k1.iters``) and the rows it skipped (``k1.skipped``) as the
  kernel does. It takes every row through all ``iters`` iterations, a
  frozen row unchanged, and then gives the skipped rows the kernel's zeros,
  so it keeps no ``k1.end``.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import NamedTuple

import torch

from doa_mpc_tpu_torch.ops import cuda_build
from doa_mpc_tpu_torch.ops.ip_qp import IpSolution
from doa_mpc_tpu_torch.ops.ocp_qp import IDXBX, OcpQp, normalize_cost, scatter_idxbx
from doa_mpc_tpu_torch.utils.profiling import keep, tracing

_T_FLOOR = 1e-12
_ZL_FLOOR = 1e-6
_F32MAX = 3.0e38
_TINY = 1e-30

KERNEL_SOURCE = os.path.join(cuda_build.CSRC_DIR, "ip_solve.cu")


class QpStructure(NamedTuple):
    """Static structure guarantees about the QP data
    (``doa_mpc_tpu.ops.ip_pallas.QpStructure``). The kernel has one
    instantiation per structure it knows (:data:`GENERIC_STRUCTURE`, right
    for any QP, and :data:`UNICYCLE_QP_STRUCTURE`); the caller asserts the
    declaration, which nothing checks on the device."""

    q_diag: bool = False
    r_diag: bool = False
    s_zero: bool = False
    c_cols: tuple | None = None
    a_unit_cols: tuple = ()
    zl_eq_zl2: bool = False


GENERIC_STRUCTURE = QpStructure()
# The static structure of every QP ``RtiController.build_qp`` produces
# (diagonal Q/R, S == 0, C nonzero only in the x/y columns, identity x/y
# columns of A, Zl == zl); tests/test_torch_rti.py checks each clause.
UNICYCLE_QP_STRUCTURE = QpStructure(
    q_diag=True, r_diag=True, s_zero=True,
    c_cols=(0, 1), a_unit_cols=(0, 1), zl_eq_zl2=True)
# the kernel's instantiation for each structure it knows
_STRUCTURE_IDS = {GENERIC_STRUCTURE: 0, UNICYCLE_QP_STRUCTURE: 1}


def _constants(dtype, reg, tol):
    """(tol, reg, sigma_max, stat_tol) as ``ip_pallas.py:1212-1217`` picks them."""
    is32 = dtype == torch.float32
    tol = (1e-7 if is32 else 1e-10) if tol is None else tol
    reg = (1e-6 if is32 else 1e-9) if reg is None else reg
    sigma_max = 1e7 if is32 else 1e12
    stat_tol = 1e-4 if is32 else 1e-8
    return tol, reg, sigma_max, stat_tol


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------

def _mv(A, x):
    """A @ x over trailing (n, m) x (m,)."""
    return (A * x.unsqueeze(-2)).sum(-1)


def _mtv(A, x):
    """A' @ x over trailing (n, m) x (n,)."""
    return (A * x.unsqueeze(-1)).sum(-2)


def _mm(A, B):
    return (A.unsqueeze(-1) * B.unsqueeze(-3)).sum(-2)


def _sel(v):
    return v[..., list(IDXBX)]


def _chol(H, reg):
    """Lower Cholesky factor of a small SPD batch (..., n, n) with ``reg``
    added to the diagonal and each pivot floored at 1e-30 (``_chol_small``)."""
    n = H.shape[-1]
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        acc = H[..., j, j] + reg
        for t in range(j):
            acc = acc - L[j][t] * L[j][t]
        L[j][j] = torch.sqrt(torch.clamp_min(acc, 1e-30))
        for i in range(j + 1, n):
            a = H[..., i, j]
            for t in range(j):
                a = a - L[i][t] * L[j][t]
            L[i][j] = a / L[j][j]
    return L


def _chol_solve(L, b):
    """Solve (L L') x = b; ``b`` (..., n) or (..., n, cols) with n leading."""
    n = len(L)
    y = [None] * n
    for i in range(n):
        acc = b[..., i] if b.ndim == L[0][0].ndim + 1 else b[..., i, :]
        for t in range(i):
            acc = acc - _bc(L[i][t], acc) * y[t]
        y[i] = acc / _bc(L[i][i], acc)
    x = [None] * n
    for i in reversed(range(n)):
        acc = y[i]
        for t in range(i + 1, n):
            acc = acc - _bc(L[t][i], acc) * x[t]
        x[i] = acc / _bc(L[i][i], acc)
    return torch.stack(x, dim=-1 if b.ndim == L[0][0].ndim + 1 else -2)


def _bc(s, a):
    return s.reshape(s.shape + (1,) * (a.ndim - s.ndim))


def _ftb(pairs, nb, like):
    """min(2, min over v / -dv where dv < 0) per scenario (2.0 is the
    sentinel when no component decreases)."""
    a = torch.full((nb,), 2.0, dtype=like.dtype, device=like.device)
    for v, dv in pairs:
        neg = dv < 0
        ratio = torch.where(neg, v / torch.where(neg, -dv, 1.0), 2.0)
        a = torch.minimum(a, torch.amin(ratio.flatten(1), dim=1))
    return a


def _check_skip(skip: torch.Tensor | None, qp: OcpQp) -> torch.Tensor | None:
    """The mask of rows to skip as the kernel reads it (contiguous), or None;
    raises unless it is bool, (B,) and on the QP's device."""
    if skip is None:
        return None
    if skip.dtype != torch.bool:
        raise TypeError(f"skip must be a bool mask; it is {skip.dtype}")
    if tuple(skip.shape) != qp.A.shape[:1]:
        raise ValueError(f"skip has shape {tuple(skip.shape)}, expected {tuple(qp.A.shape[:1])}")
    if skip.device != qp.A.device:
        raise ValueError(f"skip is on {skip.device}, the QP on {qp.A.device}")
    return skip.contiguous()


def solve_ocp_qp_fused_ref(qp: OcpQp, iters: int = 50, tau: float = 0.99,
                           reg: float | None = None, tol: float | None = None,
                           normalize: bool = True,
                           structure: QpStructure | None = None,
                           skip: torch.Tensor | None = None) -> IpSolution:
    """Plain PyTorch version of kernel K1 (module docstring lists the
    formulas it shares with the kernel and not with ``ip_qp``)."""
    if iters < 1:
        raise ValueError("iters must be >= 1")
    skip = _check_skip(skip, qp)
    dtype = qp.Q.dtype
    tol, reg, sigma_max, stat_tol = _constants(dtype, reg, tol)
    if normalize:
        qp, kappa = normalize_cost(qp)
    else:
        kappa = torch.ones(qp.A.shape[:1], dtype=dtype, device=qp.A.device)
    nb, N, nx = qp.A.shape[0], qp.A.shape[1], qp.A.shape[-1]
    M = qp.C.shape[-2]
    nbx = len(IDXBX)
    n_pairs = float(2 * N * qp.B.shape[-1] + 2 * (N + 1) * nbx + 2 * (N + 1) * M)
    A, Bm, C = qp.A, qp.B, qp.C
    At, Bt = A.transpose(-1, -2), Bm.transpose(-1, -2)
    Zl = torch.clamp_min(qp.Zl, _ZL_FLOOR)

    # ---- initialization ----------------------------------------------------
    xs = [qp.dx0]
    for k in range(N):
        xs.append(_mv(A[:, k], xs[-1]) + qp.c[:, k])
    dx = torch.stack(xs, 1)
    du = torch.zeros_like(qp.r)
    g = qp.hval + _mv(C, dx)
    s = torch.clamp_min(0.1 - g, 0.1)
    t_h = torch.clamp_min(g + s, 0.1)
    l_h, l_s = 1.0 / t_h, 1.0 / s
    t_xl = torch.clamp_min(_sel(dx) - qp.lb_x, 0.1)
    t_xu = torch.clamp_min(qp.ub_x - _sel(dx), 0.1)
    t_ul = torch.clamp_min(-qp.lb_u, 0.1)
    t_uu = torch.clamp_min(qp.ub_u, 0.1)
    l_xl, l_xu, l_ul, l_uu = 1.0 / t_xl, 1.0 / t_xu, 1.0 / t_ul, 1.0 / t_uu
    nu = torch.zeros_like(qp.c)

    # while a profiler records: each row's iterations that updated it
    used = torch.zeros((nb,), dtype=torch.int32, device=dx.device) if tracing() else None

    def sig(l, t):
        return torch.clamp(l / torch.clamp_min(t, _T_FLOOR), 0.0, sigma_max)

    for _ in range(iters):
        # ---- residuals of the pre-update iterate ---------------------------
        sdx = _sel(dx)
        rxl = sdx - qp.lb_x - t_xl
        rxu = qp.ub_x - sdx - t_xu
        Cdx = _mv(C, dx)
        rh = qp.hval + Cdx + s - t_h
        rs = Zl * s + qp.zl - l_h - l_s
        rul = du - qp.lb_u - t_ul
        ruu = qp.ub_u - du - t_uu
        ru = (_mv(qp.R, du) + qp.r + _mv(qp.S, dx[:, :-1]) - _mtv(Bm, nu)
              - (l_ul - l_uu))
        acc = _mv(qp.Q, dx) + qp.q
        acc[:, :N] = acc[:, :N] + _mtv(qp.S, du)
        acc[:, :N] = acc[:, :N] - _mtv(A, nu)
        acc[:, 1:] = acc[:, 1:] + nu
        acc[..., list(IDXBX)] = acc[..., list(IDXBX)] - (l_xl - l_xu)
        rx = acc - _mtv(C, l_h)

        mu = ((t_xl * l_xl + t_xu * l_xu).flatten(1).sum(1)
              + (t_h * l_h + s * l_s).flatten(1).sum(1)
              + (t_ul * l_ul + t_uu * l_uu).flatten(1).sum(1)) / n_pairs
        stat = torch.maximum(torch.amax(torch.abs(rx[:, 1:]).flatten(1), 1),
                             torch.amax(torch.abs(ru).flatten(1), 1))

        # ---- sigmas and the condensed Hessian ------------------------------
        sxl, sxu, sul, suu = sig(l_xl, t_xl), sig(l_xu, t_xu), sig(l_ul, t_ul), sig(l_uu, t_uu)
        sh, ss = sig(l_h, t_h), sig(l_s, s)
        zeta = Zl + sh + ss
        seff = sh * (Zl + ss) / zeta
        Qbar = (qp.Q + torch.diag_embed(scatter_idxbx(sxl + sxu, nx))
                + _mm(C.transpose(-1, -2) * seff.unsqueeze(-2), C))
        # the kernel builds the upper triangle and mirrors it
        Qbar = torch.triu(Qbar) + torch.triu(Qbar, 1).transpose(-1, -2)
        Rbar = qp.R + torch.diag_embed(sul + suu)

        # ---- backward Riccati factorization (shared) -----------------------
        Ps, Ls, Ks = [None] * N, [None] * N, [None] * N
        P = Qbar[:, N]
        for k in reversed(range(N)):
            Ps[k] = P
            PB, PA = _mm(P, Bm[:, k]), _mm(P, A[:, k])
            Huu = Rbar[:, k] + _mm(Bt[:, k], PB)
            Hux = qp.S[:, k] + _mm(Bt[:, k], PA)
            Ls[k] = _chol(Huu, reg)
            Ks[k] = -_chol_solve(Ls[k], Hux)
            Pk = Qbar[:, k] + (_mm(At[:, k], PA) + _mm(Hux.transpose(-1, -2), Ks[k]))
            P = 0.5 * (Pk + Pk.transpose(-1, -2))
        Pst = torch.stack(Ps, 1)
        d = -(dx[:, 1:] - _mv(A, dx[:, :-1]) - _mv(Bm, du) - qp.c)

        def direction(b_xl, b_xu, b_h, b_s, b_ul, b_uu):
            """Newton direction for the given betas: LQR back-substitution,
            forward rollout, then the stage-local recoveries."""
            qb = rx.clone()
            qb[..., list(IDXBX)] = (qb[..., list(IDXBX)] - (b_xl - sxl * rxl)
                                    + (b_xu - sxu * rxu))
            rho = -rs + b_h + b_s - sh * rh
            qbar = qb - _mtv(C, b_h - sh * rh - sh * rho / zeta)
            rbar = ru - (b_ul - sul * rul) + (b_uu - suu * ruu)
            p = qbar[:, N]
            pns, kffs = [None] * N, [None] * N
            for k in reversed(range(N)):
                pns[k] = p
                Pd_p = _mv(Ps[k], d[:, k]) + p
                m = rbar[:, k] + _mtv(Bm[:, k], Pd_p)
                kffs[k] = -_chol_solve(Ls[k], m)
                p = qbar[:, k] + (_mtv(A[:, k], Pd_p) + _mtv(Ks[k], m))
            x = torch.zeros_like(qp.dx0)
            Xs, Us = [x], []
            for k in range(N):
                u = _mv(Ks[k], x) + kffs[k]
                x = _mv(A[:, k], x) + _mv(Bm[:, k], u) + d[:, k]
                Xs.append(x)
                Us.append(u)
            Dx, Du = torch.stack(Xs, 1), torch.stack(Us, 1)
            Pxn = _mv(Pst, Dx[:, 1:]) + torch.stack(pns, 1)
            CD = _mv(C, Dx)
            ds = (rho - sh * CD) / zeta
            dth = CD + ds + rh
            xsel = _sel(Dx)
            dtxl, dtxu = xsel + rxl, -xsel + rxu
            dtul, dtuu = Du + rul, -Du + ruu
            return dict(dx=Dx, du=Du, Pxn=Pxn, s=ds, th=dth,
                        lh=b_h - sh * dth, ls=b_s - ss * ds,
                        txl=dtxl, txu=dtxu, lxl=b_xl - sxl * dtxl, lxu=b_xu - sxu * dtxu,
                        tul=dtul, tuu=dtuu, lul=b_ul - sul * dtul, luu=b_uu - suu * dtuu)

        def prim(D):
            return [(t_h, D["th"]), (s, D["s"]), (t_xl, D["txl"]), (t_xu, D["txu"]),
                    (t_ul, D["tul"]), (t_uu, D["tuu"])]

        def dual(D):
            return [(l_h, D["lh"]), (l_s, D["ls"]), (l_xl, D["lxl"]), (l_xu, D["lxu"]),
                    (l_ul, D["lul"]), (l_uu, D["luu"])]

        # ---- predictor ------------------------------------------------------
        aff = direction(-l_xl, -l_xu, -l_h, -l_s, -l_ul, -l_uu)
        ap = torch.clamp_max(_ftb(prim(aff), nb, mu), 1.0)
        ad = torch.clamp_max(_ftb(dual(aff), nb, mu), 1.0)
        S1 = S2 = S3 = torch.zeros_like(mu)
        for (t, dt), (l, dl) in zip(prim(aff), dual(aff)):
            S1 = S1 + (dt * l).flatten(1).sum(1)
            S2 = S2 + (t * dl).flatten(1).sum(1)
            S3 = S3 + (dt * dl).flatten(1).sum(1)
        mu_aff = (mu * n_pairs + ap * S1 + ad * S2 + ap * ad * S3) / n_pairs
        sig_c = torch.clamp((mu_aff / torch.clamp_min(mu, _T_FLOOR)) ** 3, 0.0, 1.0)
        mu_t = sig_c * mu

        # ---- corrector ------------------------------------------------------
        def beta(t, l, dt_a, dl_a):
            return (_bc(mu_t, t) - t * l - dt_a * dl_a) / torch.clamp_min(t, _T_FLOOR)

        cor = direction(beta(t_xl, l_xl, aff["txl"], aff["lxl"]),
                        beta(t_xu, l_xu, aff["txu"], aff["lxu"]),
                        beta(t_h, l_h, aff["th"], aff["lh"]),
                        beta(s, l_s, aff["s"], aff["ls"]),
                        beta(t_ul, l_ul, aff["tul"], aff["lul"]),
                        beta(t_uu, l_uu, aff["tuu"], aff["luu"]))
        a_p = torch.clamp_max(tau * _ftb(prim(cor), nb, mu), 1.0)
        a_d = torch.clamp_max(tau * _ftb(dual(cor), nb, mu), 1.0)

        chk = sum(v.flatten(1).sum(1) for v in cor.values())
        converged = (mu < tol) & (stat < stat_tol)
        finite = (torch.abs(chk) < _F32MAX) & (chk == chk) & (a_p == a_p) & (a_d == a_d)
        frozen = converged | ~finite
        if used is not None:
            used += (~frozen).to(torch.int32)

        def upd(old, a, step, positive=False):
            v = old + _bc(a, old) * step
            if positive:
                v = torch.clamp_min(v, _TINY)
            return torch.where(_bc(frozen, old), old, v)

        dx, du = upd(dx, a_p, cor["dx"]), upd(du, a_p, cor["du"])
        s = upd(s, a_p, cor["s"], True)
        nu = upd(nu, a_d, -cor["Pxn"])
        t_h, l_h = upd(t_h, a_p, cor["th"], True), upd(l_h, a_d, cor["lh"], True)
        l_s = upd(l_s, a_d, cor["ls"], True)
        t_xl, l_xl = upd(t_xl, a_p, cor["txl"], True), upd(l_xl, a_d, cor["lxl"], True)
        t_xu, l_xu = upd(t_xu, a_p, cor["txu"], True), upd(l_xu, a_d, cor["lxu"], True)
        t_ul, l_ul = upd(t_ul, a_p, cor["tul"], True), upd(l_ul, a_d, cor["lul"], True)
        t_uu, l_uu = upd(t_uu, a_p, cor["tuu"], True), upd(l_uu, a_d, cor["luu"], True)

    if skip is not None:
        # the kernel's outputs for a row it skips
        dx, du, s, mu, stat = (torch.where(_bc(skip, a), 0.0, a) for a in (dx, du, s, mu, stat))
        if used is not None:
            used = torch.where(skip, 0, used)
            keep("k1.skipped", skip.sum(dtype=torch.int32).reshape(1))
    if used is not None:
        keep("k1.iters", used)
    return IpSolution(dx=dx, du=du, s=s, mu=mu, kappa=kappa, stat_res=stat)


# ---------------------------------------------------------------------------
# the CUDA kernel: build, bind, launch
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _library():
    ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    return cuda_build.load(KERNEL_SOURCE, "ip_solve", {
        "f32": (i32, [ptr] * 22 + [i32] * 4 + [f32] * 5 + [i32, i64, i64] + [ptr] * 7),
        "plan": (i32, [i32] * 4 + [ctypes.POINTER(i64)]),
        "smem_bytes": (i64, [i32] * 3)})


def structure_id(structure: QpStructure | None) -> int:
    """The kernel instantiation for a declared structure: 0 generic (None or
    :data:`GENERIC_STRUCTURE`), 1 unicycle; any other declaration raises."""
    sid = _STRUCTURE_IDS.get(GENERIC_STRUCTURE if structure is None else structure)
    if sid is None:
        raise ValueError(f"no kernel instantiation for {structure}; declare "
                         "GENERIC_STRUCTURE or UNICYCLE_QP_STRUCTURE")
    return sid


def smem_bytes(N: int, M: int, structure: QpStructure | None = None) -> int:
    """Shared memory that one block of the kernel (one warp, two scenarios
    of 16 lanes) needs to hold its scenarios' arrays on chip, as
    ``csrc/ip_solve.cu`` sizes them."""
    return _library().ip_solve_smem_bytes(structure_id(structure), N, M)


@functools.lru_cache(maxsize=None)
def _plan(device: int, sid: int, nb: int, N: int, M: int) -> cuda_build.Plan:
    return cuda_build.plan(_library(), "ip_solve", device, sid, nb, N, M)


def plan(nb: int, N: int, M: int, structure: QpStructure | None = None) -> cuda_build.Plan:
    """How a launch of ``nb`` scenarios runs on the current card
    (``ip_solve_plan``, made once per card and shape): every resident tile,
    at most one per scenario; the arrays in shared memory when a block holds
    its two scenarios' (13-15 KB each at N=20, M=5), else in a device-memory
    workspace of one slice per tile, which the wrapper allocates."""
    return _plan(torch.cuda.current_device(), structure_id(structure), nb, N, M)


def _check_cuda_qp(qp: OcpQp) -> None:
    dev = qp.A.device
    for name, a in qp._asdict().items():
        if a.device != dev:
            raise ValueError(f"OcpQp.{name} is on {a.device}, A on {dev}")
        if a.dtype != torch.float32:
            raise TypeError(f"the CUDA kernel takes float32; OcpQp.{name} is {a.dtype}")
    nb, N, nx = qp.A.shape[0], qp.A.shape[1], qp.A.shape[-1]
    nu, M = qp.B.shape[-1], qp.C.shape[-2]
    want = dict(A=(nb, N, 5, 5), B=(nb, N, 5, 2), c=(nb, N, 5), dx0=(nb, 5),
                Q=(nb, N + 1, 5, 5), q=(nb, N + 1, 5), R=(nb, N, 2, 2),
                r=(nb, N, 2), S=(nb, N, 2, 5), lb_u=(nb, N, 2), ub_u=(nb, N, 2),
                lb_x=(nb, N + 1, 4), ub_x=(nb, N + 1, 4), C=(nb, N + 1, M, 5),
                hval=(nb, N + 1, M), zl=(nb, N + 1, M), Zl=(nb, N + 1, M))
    if (nx, nu) != (5, 2) or N < 1 or nb < 1:
        raise ValueError(f"the CUDA kernel is built for nx=5, nu=2; got nx={nx}, nu={nu}, N={N}")
    for name, shape in want.items():
        if tuple(getattr(qp, name).shape) != shape:
            raise ValueError(f"OcpQp.{name} has shape {tuple(getattr(qp, name).shape)}, "
                             f"expected {shape}")


def solve_ocp_qp_fused(qp: OcpQp, iters: int = 50, tau: float = 0.99,
                       reg: float | None = None, tol: float | None = None,
                       normalize: bool = True,
                       structure: QpStructure | None = None,
                       skip: torch.Tensor | None = None) -> IpSolution:
    """Whole interior-point solve of a batch of QPs (one leading batch axis).

    CPU tensors run :func:`solve_ocp_qp_fused_ref`. CUDA tensors (float32,
    nx = 5, nu = 2) launch the kernel instantiated for ``structure`` (see
    :func:`structure_id`) once and add one to ``solve_ocp_qp_fused.launches``;
    anything else raises. Rows marked in ``skip`` get zeros (module
    docstring)."""
    sid = structure_id(structure)
    dev = qp.A.device
    if dev.type == "cpu":
        return solve_ocp_qp_fused_ref(qp, iters=iters, tau=tau, reg=reg, tol=tol,
                                      normalize=normalize, structure=structure, skip=skip)
    if dev.type != "cuda":
        raise ValueError(f"solve_ocp_qp_fused: unsupported device {dev}")
    if iters < 1:
        raise ValueError("iters must be >= 1")
    _check_cuda_qp(qp)
    skip = _check_skip(skip, qp)
    tol, reg, sigma_max, stat_tol = _constants(torch.float32, reg, tol)
    if normalize:
        qp, kappa = normalize_cost(qp)
    else:
        kappa = torch.ones(qp.A.shape[:1], dtype=torch.float32, device=dev)
    nb, N, M = qp.A.shape[0], qp.A.shape[1], qp.C.shape[-2]
    ins = [a.contiguous() for a in qp]        # batch-first, as they come
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty((nb, N + 1, 5), **f32)
    du = torch.empty((nb, N, 2), **f32)
    s = torch.empty((nb, N + 1, M), **f32)
    mu = torch.empty((nb,), **f32)
    stat = torch.empty((nb,), **f32)
    i32 = dict(dtype=torch.int32, device=dev)
    nxt = torch.empty((1,), **i32)    # the hand-out counter; the launch zeroes it
    # while a profiler records, the kernel writes each row's counts and the
    # rows it skipped (an int the launch zeroes)
    end, used = (torch.empty((nb,), **i32) for _ in range(2)) if tracing() else (None, None)
    skipped = torch.empty((1,), **i32) if used is not None and skip is not None else None
    pl = _plan(dev.index, sid, nb, N, M)
    work = torch.empty((pl.work,), **f32) if pl.work else None
    cuda_build.launch(
        _library(), "ip_solve", "f32", dev,
        *[a.data_ptr() for a in ins + [dx, du, s, mu, stat]], nb, N, M, int(iters), reg, tau,
        tol, stat_tol, sigma_max, sid, pl.blocks, pl.bytes,
        *[None if a is None else a.data_ptr() for a in (work, nxt, skip, skipped, end, used)],
        what=f"ip_solve_f32 launch failed (N={N}, M={M}, {pl.bytes} B of shared memory per "
             f"block, {pl.work} floats of workspace)")
    solve_ocp_qp_fused.launches += 1
    if used is not None:
        keep("k1.iters", used)
        keep("k1.end", end)
    if skipped is not None:
        keep("k1.skipped", skipped)
    return IpSolution(dx=dx, du=du, s=s, mu=mu, kappa=kappa, stat_res=stat)


solve_ocp_qp_fused.launches = 0
