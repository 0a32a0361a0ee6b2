"""Block-tridiagonal Riccati factorization for OCP-structured Newton systems
(``doa_mpc_tpu/ops/riccati.py``).

The equality-constrained LQR subproblem of each interior-point iteration is
solved by a backward Riccati sweep and a forward rollout. Factorization and
back-substitution are split so one factorization serves several right-hand
sides (the Mehrotra predictor and corrector share the stage Hessians).

Problem solved, per scenario:

    min   sum_k 1/2 x_k'Q_k x_k + q_k'x_k + 1/2 u_k'R_k u_k + r_k'u_k
          + u_k'S_k x_k          (k = 0..N-1, terminal k=N has Q, q only)
    s.t.  x_{k+1} = A_k x_k + B_k u_k + d_k,      x_0 given.

Every array may carry leading batch axes (the scenario axis) before its
stage axis; the stage recursions are Python loops over N, and each step is
one batched tensor op over the scenarios.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class RiccatiFactors(NamedTuple):
    """Backward-sweep products reused across right-hand sides.

    ``P``: (..., N+1, nx, nx) cost-to-go Hessians; ``Luu``: (..., N, nu, nu)
    lower Cholesky factors of Huu_k = R_k + B_k' P_{k+1} B_k + reg I;
    ``K``: (..., N, nu, nx) feedback gains; ``A``/``B`` are carried for the
    solve pass.
    """

    P: torch.Tensor
    Luu: torch.Tensor
    K: torch.Tensor
    A: torch.Tensor
    B: torch.Tensor


def _sym(M):
    return 0.5 * (M + M.mT)


def _mv(A, x):
    return (A @ x.unsqueeze(-1)).squeeze(-1)


def _stage(a, k):
    """Stage ``k`` of a (..., stages, rows, cols) array."""
    return a[..., k, :, :]


def _cholesky(H):
    """Lower Cholesky factor; a factor that fails is NaN, as JAX's
    ``cho_factor`` gives it. ``cholesky_ex`` leaves the check on the device,
    so the factorization never waits for the host."""
    L, info = torch.linalg.cholesky_ex(H)
    return torch.where((info != 0)[..., None, None], torch.nan, L)


def riccati_factorize(Q, R, S, A, B, reg: float = 0.0) -> RiccatiFactors:
    """Backward Riccati sweep over the stage Hessians.

    Q (..., N+1, nx, nx), R (..., N, nu, nu), S (..., N, nu, nx),
    A (..., N, nx, nx), B (..., N, nx, nu). ``reg`` is a jitter added to Huu
    before the Cholesky."""
    N, nu = A.shape[-3], R.shape[-1]
    eye_u = torch.eye(nu, dtype=R.dtype, device=R.device)
    P = _sym(_stage(Q, N))
    Ps, Ls, Ks = [None] * N, [None] * N, [None] * N
    P_N = P
    for k in reversed(range(N)):
        Ak, Bk = _stage(A, k), _stage(B, k)
        PB = P @ Bk                                        # (nx, nu)
        Huu = _sym(_stage(R, k) + Bk.mT @ PB + reg * eye_u)
        Lc = _cholesky(Huu)
        PA = P @ Ak
        Hux = _stage(S, k) + Bk.mT @ PA                    # (nu, nx)
        K = -torch.cholesky_solve(Hux, Lc)
        P = _sym(_stage(Q, k) + Ak.mT @ PA + Hux.mT @ K)
        Ps[k], Ls[k], Ks[k] = P, Lc, K
    return RiccatiFactors(P=torch.stack(Ps + [P_N], -3), Luu=torch.stack(Ls, -3),
                          K=torch.stack(Ks, -3), A=A, B=B)


def riccati_solve(fac: RiccatiFactors, q, r, d, x0):
    """Back-substitution for one right-hand side.

    q (..., N+1, nx), r (..., N, nu), d (..., N, nx) dynamics affine terms,
    x0 (..., nx) fixed initial state. Returns (x (..., N+1, nx),
    u (..., N, nu), nu_dyn (..., N, nx)) where ``nu_dyn[k]`` is the
    multiplier of the k-th dynamics constraint under the convention
    Q x_k + q_k + nu_{k-1} - A' nu_k = 0: nu_k = -(P_{k+1} x_{k+1} + p_{k+1}).
    """
    A, B, P, Luu, K = fac.A, fac.B, fac.P, fac.Luu, fac.K
    N = A.shape[-3]
    p = q[..., N, :]
    kffs, p_next = [None] * N, [None] * N
    for k in reversed(range(N)):
        p_next[k] = p
        Pd_p = _mv(_stage(P, k + 1), d[..., k, :]) + p
        m = r[..., k, :] + _mv(_stage(B, k).mT, Pd_p)
        kffs[k] = -torch.cholesky_solve(m.unsqueeze(-1), _stage(Luu, k)).squeeze(-1)
        p = q[..., k, :] + _mv(_stage(A, k).mT, Pd_p) + _mv(_stage(K, k).mT, m)
    x, xs, us = x0, [x0], []
    for k in range(N):
        u = _mv(_stage(K, k), x) + kffs[k]
        x = _mv(_stage(A, k), x) + _mv(_stage(B, k), u) + d[..., k, :]
        xs.append(x)
        us.append(u)
    x = torch.stack(xs, -2)
    nu_dyn = -(_mv(P[..., 1:, :, :], x[..., 1:, :]) + torch.stack(p_next, -2))
    return x, torch.stack(us, -2), nu_dyn
