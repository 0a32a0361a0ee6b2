"""The plain reference of the batched campaign tick's QP solve
(:func:`solve_k1`): a primal-dual Mehrotra predictor-corrector
interior-point method on the OCP-structured QP, with a fixed iteration
budget and per-row masked convergence, in the whole-solve formulas (every
residual from the pre-update iterate, ``mu_aff`` from the summed products,
fraction-to-boundary as ``min(1, tau min ratio)``, Cholesky with ``reg`` and
a 1e-30 pivot floor), regularization 1e-6.

It takes the float32 constants the configuration's precision states
(tol 1e-7, stat_tol 1e-4, sigma_max 1e7), whatever dtype it computes in.
Imports nothing of the program.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

IDXBX = [0, 1, 3, 4]
T_FLOOR, ZL_FLOOR, TINY, F32MAX = 1e-12, 1e-6, 1e-30, 3.0e38
TOL, STAT_TOL, SIGMA_MAX, K1_REG = 1e-7, 1e-4, 1e7, 1e-6


class Qp(NamedTuple):
    """Batch-first QP data: A (B,N,nx,nx), B (B,N,nx,nu), c (B,N,nx), dx0
    (B,nx), Q (B,N+1,nx,nx), q (B,N+1,nx), R (B,N,nu,nu), r (B,N,nu), S
    (B,N,nu,nx), lb_u/ub_u (B,N,nu), lb_x/ub_x (B,N+1,4), C (B,N+1,M,nx),
    hval/zl/Zl (B,N+1,M)."""

    A: torch.Tensor
    B: torch.Tensor
    c: torch.Tensor
    dx0: torch.Tensor
    Q: torch.Tensor
    q: torch.Tensor
    R: torch.Tensor
    r: torch.Tensor
    S: torch.Tensor
    lb_u: torch.Tensor
    ub_u: torch.Tensor
    lb_x: torch.Tensor
    ub_x: torch.Tensor
    C: torch.Tensor
    hval: torch.Tensor
    zl: torch.Tensor
    Zl: torch.Tensor


def mv(A, x):
    return (A * x.unsqueeze(-2)).sum(-1)


def mtv(A, x):
    return (A * x.unsqueeze(-1)).sum(-2)


def mm(A, B):
    return (A.unsqueeze(-1) * B.unsqueeze(-3)).sum(-2)


def bc(s, a):
    return s.reshape(s.shape + (1,) * (a.ndim - s.ndim))


def rsum(a):
    return a.flatten(1).sum(1)


def sel_t(v, nx):
    out = torch.zeros(v.shape[:-1] + (nx,), dtype=v.dtype, device=v.device)
    out[..., IDXBX] = v
    return out


def normalize(qp: Qp) -> Qp:
    """Scale each row's objective by 1 / max(|diag Q|, |diag R|, zl, Zl, 1)."""
    def rmax(a):
        return a.flatten(1).amax(1)
    kappa = torch.maximum(
        torch.maximum(rmax(torch.diagonal(qp.Q, dim1=-2, dim2=-1).abs()),
                      rmax(torch.diagonal(qp.R, dim1=-2, dim2=-1).abs())),
        torch.maximum(torch.maximum(rmax(qp.zl), rmax(qp.Zl)), torch.ones_like(qp.zl[:, 0, 0])))
    inv = 1.0 / kappa
    return qp._replace(**{k: getattr(qp, k) * bc(inv, getattr(qp, k))
                          for k in ("Q", "q", "R", "r", "S", "zl", "Zl")})


def _chol(H, reg):
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
    """(L L') x = b; ``b`` (..., n) or (..., n, cols)."""
    n = len(L)
    vec = b.ndim == L[0][0].ndim + 1
    y = [None] * n
    for i in range(n):
        acc = b[..., i] if vec else b[..., i, :]
        for t in range(i):
            acc = acc - bc(L[i][t], acc) * y[t]
        y[i] = acc / bc(L[i][i], acc)
    x = [None] * n
    for i in reversed(range(n)):
        acc = y[i]
        for t in range(i + 1, n):
            acc = acc - bc(L[t][i], acc) * x[t]
        x[i] = acc / bc(L[i][i], acc)
    return torch.stack(x, dim=-1 if vec else -2)


def _ftb(pairs, nb, like):
    a = torch.full((nb,), 2.0, dtype=like.dtype, device=like.device)
    for v, dv in pairs:
        neg = dv < 0
        ratio = torch.where(neg, v / torch.where(neg, -dv, torch.ones_like(dv)),
                            torch.full_like(dv, 2.0))
        a = torch.minimum(a, ratio.flatten(1).amin(1))
    return a


def solve_k1(qp: Qp, iters: int, tau: float, reg: float = K1_REG):
    """The batched tick's whole interior-point solve; returns (dx, du)."""
    qp = normalize(qp)
    nb, N, nx = qp.A.shape[0], qp.A.shape[1], qp.A.shape[-1]
    M = qp.C.shape[-2]
    n_pairs = float(2 * N * qp.B.shape[-1] + 2 * (N + 1) * 4 + 2 * (N + 1) * M)
    A, Bm, C = qp.A, qp.B, qp.C
    At, Bt = A.transpose(-1, -2), Bm.transpose(-1, -2)
    Zl = torch.clamp_min(qp.Zl, ZL_FLOOR)

    xs = [qp.dx0]
    for k in range(N):
        xs.append(mv(A[:, k], xs[-1]) + qp.c[:, k])
    dx = torch.stack(xs, 1)
    du = torch.zeros_like(qp.r)
    g = qp.hval + mv(C, dx)
    s = torch.clamp_min(0.1 - g, 0.1)
    t_h = torch.clamp_min(g + s, 0.1)
    l_h, l_s = 1.0 / t_h, 1.0 / s
    t_xl = torch.clamp_min(dx[..., IDXBX] - qp.lb_x, 0.1)
    t_xu = torch.clamp_min(qp.ub_x - dx[..., IDXBX], 0.1)
    t_ul = torch.clamp_min(-qp.lb_u, 0.1)
    t_uu = torch.clamp_min(qp.ub_u, 0.1)
    l_xl, l_xu, l_ul, l_uu = 1.0 / t_xl, 1.0 / t_xu, 1.0 / t_ul, 1.0 / t_uu
    nu = torch.zeros_like(qp.c)

    def sig(l, t):
        return torch.clamp(l / torch.clamp_min(t, T_FLOOR), 0.0, SIGMA_MAX)

    for _ in range(iters):
        sdx = dx[..., IDXBX]
        rxl, rxu = sdx - qp.lb_x - t_xl, qp.ub_x - sdx - t_xu
        rh = qp.hval + mv(C, dx) + s - t_h
        rs = Zl * s + qp.zl - l_h - l_s
        rul, ruu = du - qp.lb_u - t_ul, qp.ub_u - du - t_uu
        ru = mv(qp.R, du) + qp.r + mv(qp.S, dx[:, :-1]) - mtv(Bm, nu) - (l_ul - l_uu)
        acc = mv(qp.Q, dx) + qp.q
        acc[:, :N] = acc[:, :N] + mtv(qp.S, du) - mtv(A, nu)
        acc[:, 1:] = acc[:, 1:] + nu
        acc[..., IDXBX] = acc[..., IDXBX] - (l_xl - l_xu)
        rx = acc - mtv(C, l_h)
        mu = (rsum(t_xl * l_xl + t_xu * l_xu) + rsum(t_h * l_h + s * l_s)
              + rsum(t_ul * l_ul + t_uu * l_uu)) / n_pairs
        stat = torch.maximum(rx[:, 1:].abs().flatten(1).amax(1), ru.abs().flatten(1).amax(1))

        sxl, sxu, sul, suu = sig(l_xl, t_xl), sig(l_xu, t_xu), sig(l_ul, t_ul), sig(l_uu, t_uu)
        sh, ss = sig(l_h, t_h), sig(l_s, s)
        zeta = Zl + sh + ss
        seff = sh * (Zl + ss) / zeta
        Qbar = (qp.Q + torch.diag_embed(sel_t(sxl + sxu, nx))
                + mm(C.transpose(-1, -2) * seff.unsqueeze(-2), C))
        Qbar = torch.triu(Qbar) + torch.triu(Qbar, 1).transpose(-1, -2)
        Rbar = qp.R + torch.diag_embed(sul + suu)

        Ps, Ls, Ks = [None] * N, [None] * N, [None] * N
        P = Qbar[:, N]
        for k in reversed(range(N)):
            Ps[k] = P
            PB, PA = mm(P, Bm[:, k]), mm(P, A[:, k])
            Huu = Rbar[:, k] + mm(Bt[:, k], PB)
            Hux = qp.S[:, k] + mm(Bt[:, k], PA)
            Ls[k] = _chol(Huu, reg)
            Ks[k] = -_chol_solve(Ls[k], Hux)
            Pk = Qbar[:, k] + (mm(At[:, k], PA) + mm(Hux.transpose(-1, -2), Ks[k]))
            P = 0.5 * (Pk + Pk.transpose(-1, -2))
        Pst = torch.stack(Ps, 1)
        d = -(dx[:, 1:] - mv(A, dx[:, :-1]) - mv(Bm, du) - qp.c)

        def direction(b_xl, b_xu, b_h, b_s, b_ul, b_uu):
            qb = rx.clone()
            qb[..., IDXBX] = qb[..., IDXBX] - (b_xl - sxl * rxl) + (b_xu - sxu * rxu)
            rho = -rs + b_h + b_s - sh * rh
            qbar = qb - mtv(C, b_h - sh * rh - sh * rho / zeta)
            rbar = ru - (b_ul - sul * rul) + (b_uu - suu * ruu)
            p = qbar[:, N]
            pns, kffs = [None] * N, [None] * N
            for k in reversed(range(N)):
                pns[k] = p
                Pd_p = mv(Ps[k], d[:, k]) + p
                m = rbar[:, k] + mtv(Bm[:, k], Pd_p)
                kffs[k] = -_chol_solve(Ls[k], m)
                p = qbar[:, k] + (mtv(A[:, k], Pd_p) + mtv(Ks[k], m))
            x = torch.zeros_like(qp.dx0)
            X, U = [x], []
            for k in range(N):
                u = mv(Ks[k], x) + kffs[k]
                x = mv(A[:, k], x) + mv(Bm[:, k], u) + d[:, k]
                X.append(x)
                U.append(u)
            Dx, Du = torch.stack(X, 1), torch.stack(U, 1)
            Pxn = mv(Pst, Dx[:, 1:]) + torch.stack(pns, 1)
            CD = mv(C, Dx)
            ds = (rho - sh * CD) / zeta
            dth = CD + ds + rh
            xs_ = Dx[..., IDXBX]
            dtxl, dtxu, dtul, dtuu = xs_ + rxl, -xs_ + rxu, Du + rul, -Du + ruu
            return dict(dx=Dx, du=Du, Pxn=Pxn, s=ds, th=dth, lh=b_h - sh * dth,
                        ls=b_s - ss * ds, txl=dtxl, txu=dtxu, lxl=b_xl - sxl * dtxl,
                        lxu=b_xu - sxu * dtxu, tul=dtul, tuu=dtuu,
                        lul=b_ul - sul * dtul, luu=b_uu - suu * dtuu)

        def prim(D):
            return [(t_h, D["th"]), (s, D["s"]), (t_xl, D["txl"]), (t_xu, D["txu"]),
                    (t_ul, D["tul"]), (t_uu, D["tuu"])]

        def dual(D):
            return [(l_h, D["lh"]), (l_s, D["ls"]), (l_xl, D["lxl"]), (l_xu, D["lxu"]),
                    (l_ul, D["lul"]), (l_uu, D["luu"])]

        aff = direction(-l_xl, -l_xu, -l_h, -l_s, -l_ul, -l_uu)
        ap = torch.clamp_max(_ftb(prim(aff), nb, mu), 1.0)
        ad = torch.clamp_max(_ftb(dual(aff), nb, mu), 1.0)
        S1 = S2 = S3 = torch.zeros_like(mu)
        for (t, dt), (l, dl) in zip(prim(aff), dual(aff)):
            S1, S2, S3 = S1 + rsum(dt * l), S2 + rsum(t * dl), S3 + rsum(dt * dl)
        mu_aff = (mu * n_pairs + ap * S1 + ad * S2 + ap * ad * S3) / n_pairs
        mu_t = torch.clamp((mu_aff / torch.clamp_min(mu, T_FLOOR)) ** 3, 0.0, 1.0) * mu

        def beta(t, l, dt_a, dl_a):
            return (bc(mu_t, t) - t * l - dt_a * dl_a) / torch.clamp_min(t, T_FLOOR)

        cor = direction(beta(t_xl, l_xl, aff["txl"], aff["lxl"]),
                        beta(t_xu, l_xu, aff["txu"], aff["lxu"]),
                        beta(t_h, l_h, aff["th"], aff["lh"]),
                        beta(s, l_s, aff["s"], aff["ls"]),
                        beta(t_ul, l_ul, aff["tul"], aff["lul"]),
                        beta(t_uu, l_uu, aff["tuu"], aff["luu"]))
        a_p = torch.clamp_max(tau * _ftb(prim(cor), nb, mu), 1.0)
        a_d = torch.clamp_max(tau * _ftb(dual(cor), nb, mu), 1.0)
        chk = sum(rsum(v) for v in cor.values())
        finite = (chk.abs() < F32MAX) & (chk == chk) & (a_p == a_p) & (a_d == a_d)
        frozen = ((mu < TOL) & (stat < STAT_TOL)) | ~finite

        def upd(old, a, step, positive=False):
            v = old + bc(a, old) * step
            if positive:
                v = torch.clamp_min(v, TINY)
            return torch.where(bc(frozen, old), old, v)

        dx, du = upd(dx, a_p, cor["dx"]), upd(du, a_p, cor["du"])
        s = upd(s, a_p, cor["s"], True)
        nu = upd(nu, a_d, -cor["Pxn"])
        t_h, l_h = upd(t_h, a_p, cor["th"], True), upd(l_h, a_d, cor["lh"], True)
        l_s = upd(l_s, a_d, cor["ls"], True)
        t_xl, l_xl = upd(t_xl, a_p, cor["txl"], True), upd(l_xl, a_d, cor["lxl"], True)
        t_xu, l_xu = upd(t_xu, a_p, cor["txu"], True), upd(l_xu, a_d, cor["lxu"], True)
        t_ul, l_ul = upd(t_ul, a_p, cor["tul"], True), upd(l_ul, a_d, cor["lul"], True)
        t_uu, l_uu = upd(t_uu, a_p, cor["tuu"], True), upd(l_uu, a_d, cor["luu"], True)
    return dx, du

