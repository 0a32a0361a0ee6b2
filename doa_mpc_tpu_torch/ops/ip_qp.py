"""Batched primal-dual interior-point solver for OCP-structured QPs
(``doa_mpc_tpu/ops/ip_qp.py``).

- **Mehrotra predictor-corrector** whose Newton systems are solved by a
  block-tridiagonal Riccati sweep: ``backend="torch"`` factorizes once per
  iteration with ``ops/riccati.py`` and solves twice (the JAX package's
  ``"xla"``); ``backend="riccati"`` calls kernel K2
  (``ops/riccati_fused.py``) once per right-hand side (the JAX package's
  ``"pallas"``).
- **Soft (slacked) constraints eliminated stage-wise**: per iteration the
  obstacle slacks become a rank-M term C' diag(sigma_eff) C of the stage
  Hessian, sigma_eff = sigma_h (Zl + sigma_s) / (Zl + sigma_h + sigma_s).
- **Fixed iteration count, masked convergence**: every scenario runs
  ``iters`` iterations; a row freezes when it has converged or when any
  component of its direction is non-finite, and a row that tripped the
  non-finite guard lowers its own barrier-curvature clamp to ``sigma_retry``.
- **Infeasible start**: inequality slacks start at ``max(expr, 0.1)`` and
  the residuals carry any initial gap.

``qp`` fields carry one leading batch axis; an unbatched QP is solved as a
batch of one and returned without it. Per-iteration work stays on the
device: no host-to-device copies, and the box selection uses static slices.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from doa_mpc_tpu_torch.ops.ocp_qp import (
    IDXBX, OcpQp, gather_idxbx, normalize_cost, scatter_idxbx,
)
from doa_mpc_tpu_torch.ops.riccati import riccati_factorize, riccati_solve
from doa_mpc_tpu_torch.ops.riccati_fused import riccati_solve_fused

_T_FLOOR = 1e-12   # slack floor inside sigma = lambda / t
_ZL_FLOOR = 1e-6   # L2 slack-penalty floor (keeps zero-penalty soft rows bounded)
_TINY = 1e-30      # floor of every positive iterate after an update

BACKENDS = ("torch", "riccati")


class IpSolution(NamedTuple):
    dx: torch.Tensor        # (B, N+1, nx)
    du: torch.Tensor        # (B, N, nu)
    s: torch.Tensor         # (B, N+1, M) soft slacks
    mu: torch.Tensor        # (B,) duality measure of the last iteration
    kappa: torch.Tensor     # (B,) objective normalization used internally
    stat_res: torch.Tensor  # (B,) stationarity residual (normalized)


def _mv(A, x):
    """A @ x over trailing (n, m) x (m,)."""
    return (A @ x.unsqueeze(-1)).squeeze(-1)


def _mtv(A, x):
    """A' @ x over trailing (n, m) x (n,)."""
    return (x.unsqueeze(-2) @ A).squeeze(-2)


def _rsum(a):
    return a.flatten(1).sum(1)


def _bc(s, a):
    """Broadcast a per-row (B,) value against (B, ...) ``a``."""
    return s.reshape(s.shape + (1,) * (a.ndim - s.ndim))


def solve_ocp_qp(qp: OcpQp, iters: int = 50, tau: float = 0.99,
                 reg: float | None = None, tol: float | None = None,
                 normalize: bool = True, backend: str = "torch",
                 sigma_max: float | None = None,
                 sigma_retry: float | None = None,
                 debug: bool = False):
    """Solve OCP QPs; returns an :class:`IpSolution`, and with ``debug`` also
    a dict of the per-iteration ``mu``, ``stat``, ``alpha`` (min of the
    primal and dual step) and ``sigma`` (centering), each (iters, B).

    ``iters`` plays the role of the reference's QP_ITER. The defaults depend
    on the dtype: tol 1e-7 / 1e-10, reg 1e-6 / 1e-9, sigma_max 1e7 / 1e12,
    sigma_retry 1e5 / 1e10, stat_tol 1e-4 / 1e-8 (float32 / float64).
    ``sigma_retry=0`` disables the per-row retry cap."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} is not ported; choose from {BACKENDS}")
    if iters < 1:
        raise ValueError("iters must be >= 1")
    if qp.A.ndim == 3:
        out = solve_ocp_qp(OcpQp(*[a.unsqueeze(0) for a in qp]), iters=iters, tau=tau,
                           reg=reg, tol=tol, normalize=normalize, backend=backend,
                           sigma_max=sigma_max, sigma_retry=sigma_retry, debug=debug)
        if debug:
            sol, info = out
            return (IpSolution(*[a[0] for a in sol]),
                    {k: v[:, 0] for k, v in info.items()})
        return IpSolution(*[a[0] for a in out])
    if qp.A.ndim != 4:
        raise ValueError("qp fields carry at most one leading batch axis")

    dtype = qp.Q.dtype
    is32 = dtype == torch.float32
    tol = (1e-7 if is32 else 1e-10) if tol is None else tol
    reg = (1e-6 if is32 else 1e-9) if reg is None else reg
    sigma_max = (1e7 if is32 else 1e12) if sigma_max is None else sigma_max
    sigma_retry = (1e5 if is32 else 1e10) if sigma_retry is None else sigma_retry
    stat_tol = 1e-4 if is32 else 1e-8
    nb, N, nx = qp.A.shape[0], qp.A.shape[1], qp.A.shape[-1]
    nu, M, nbx = qp.B.shape[-1], qp.C.shape[-2], len(IDXBX)
    kw = dict(dtype=dtype, device=qp.A.device)

    if normalize:
        qp, kappa = normalize_cost(qp)
    else:
        kappa = torch.ones((nb,), **kw)
    Zl = torch.clamp_min(qp.Zl, _ZL_FLOOR)
    zero_x0 = torch.zeros((nb, nx), **kw)

    # ---- LQR backend ---------------------------------------------------------
    if backend == "riccati":
        # kernel K2 reads contiguous batch-first arrays in place: the dynamics
        # are made so once per solve
        S_c, A_c, B_c = qp.S.contiguous(), qp.A.contiguous(), qp.B.contiguous()

    def make_lqr(Qbar, Rbar):
        if backend == "riccati":
            def lqr(qbar, rbar, d):
                return riccati_solve_fused(Qbar, Rbar, S_c, A_c, B_c, qbar, rbar, d,
                                           zero_x0, reg=reg)
            return lqr
        fac = riccati_factorize(Qbar, Rbar, qp.S, qp.A, qp.B, reg=reg)
        return lambda qbar, rbar, d: riccati_solve(fac, qbar, rbar, d, zero_x0)

    # ---- initialization --------------------------------------------------------
    xs = [qp.dx0]
    for k in range(N):
        xs.append(_mv(qp.A[:, k], xs[-1]) + qp.c[:, k])
    dx = torch.stack(xs, 1)
    du = torch.zeros_like(qp.r)
    t_min = 0.1
    g_h = qp.hval + _mv(qp.C, dx)
    s = torch.clamp_min(t_min - g_h, t_min)
    t_h = torch.clamp_min(g_h + s, t_min)
    l_h, l_s = 1.0 / t_h, 1.0 / s
    t_ul = torch.clamp_min(du - qp.lb_u, t_min)
    t_uu = torch.clamp_min(qp.ub_u - du, t_min)
    t_xl = torch.clamp_min(gather_idxbx(dx) - qp.lb_x, t_min)
    t_xu = torch.clamp_min(qp.ub_x - gather_idxbx(dx), t_min)
    l_ul, l_uu, l_xl, l_xu = 1.0 / t_ul, 1.0 / t_uu, 1.0 / t_xl, 1.0 / t_xu
    nu_dyn = torch.zeros_like(qp.c)
    n_pairs = float(2 * N * nu + 2 * (N + 1) * nbx + 2 * (N + 1) * M)
    zero_x = torch.zeros((nb, 1, nx), **kw)
    sig_cap = torch.full((nb,), sigma_max, **kw)
    A_t, B_t, C_t = qp.A.mT, qp.B.mT, qp.C.mT
    mus, stats, alphas, sigs = [], [], [], []

    for _ in range(iters):
        # ---- residuals ---------------------------------------------------------
        r_ul = (du - qp.lb_u) - t_ul
        r_uu = (qp.ub_u - du) - t_uu
        r_xl = (gather_idxbx(dx) - qp.lb_x) - t_xl
        r_xu = (qp.ub_x - gather_idxbx(dx)) - t_xu
        r_h = (qp.hval + _mv(qp.C, dx) + s) - t_h
        r_s = Zl * s + qp.zl - l_h - l_s
        dx_head, dx_tail = dx[:, :-1], dx[:, 1:]
        r_dyn = dx_tail - _mv(qp.A, dx_head) - _mv(qp.B, du) - qp.c
        nu_prev = torch.cat([zero_x, nu_dyn], 1)                 # nu_{k-1}
        Atnu = torch.cat([_mv(A_t, nu_dyn), zero_x], 1)
        r_x = (_mv(qp.Q, dx) + qp.q + torch.cat([_mtv(qp.S, du), zero_x], 1)
               + nu_prev - Atnu - scatter_idxbx(l_xl - l_xu, nx) - _mv(C_t, l_h))
        r_u = (_mv(qp.R, du) + qp.r + _mv(qp.S, dx_head) - _mv(B_t, nu_dyn)
               - (l_ul - l_uu))

        # ---- sigmas and the condensed Hessian -----------------------------------
        def sig(l, t):
            return torch.minimum(torch.clamp_min(l / torch.clamp_min(t, _T_FLOOR), 0.0),
                                 _bc(sig_cap, l))

        s_ul, s_uu = sig(l_ul, t_ul), sig(l_uu, t_uu)
        s_xl, s_xu = sig(l_xl, t_xl), sig(l_xu, t_xu)
        s_h, s_s = sig(l_h, t_h), sig(l_s, s)
        zeta = Zl + s_h + s_s
        s_eff = s_h * (Zl + s_s) / zeta
        Qbar = (qp.Q + torch.diag_embed(scatter_idxbx(s_xl + s_xu, nx))
                + (C_t * s_eff.unsqueeze(-2)) @ qp.C)
        Rbar = qp.R + torch.diag_embed(s_ul + s_uu)
        lqr = make_lqr(Qbar, Rbar)

        mu = (_rsum(t_ul * l_ul) + _rsum(t_uu * l_uu) + _rsum(t_xl * l_xl)
              + _rsum(t_xu * l_xu) + _rsum(t_h * l_h) + _rsum(s * l_s)) / n_pairs

        def directions(b_ul, b_uu, b_xl, b_xu, b_h, b_s):
            rho = -r_s + b_h + b_s - s_h * r_h
            beta_hat = b_h - s_h * r_h - s_h * rho / zeta
            qbar = (r_x - scatter_idxbx(b_xl - s_xl * r_xl, nx)
                    + scatter_idxbx(b_xu - s_xu * r_xu, nx) - _mv(C_t, beta_hat))
            rbar = r_u - (b_ul - s_ul * r_ul) + (b_uu - s_uu * r_uu)
            # the LQR's costate is the Newton increment of nu_dyn
            Ddx, Ddu, Dnu = lqr(qbar, rbar, -r_dyn)
            CDdx = _mv(qp.C, Ddx)
            ds = (rho - s_h * CDdx) / zeta
            dt_h = CDdx + ds + r_h
            dt_ul, dt_uu = Ddu + r_ul, -Ddu + r_uu
            dt_xl, dt_xu = gather_idxbx(Ddx) + r_xl, -gather_idxbx(Ddx) + r_xu
            return dict(dx=Ddx, du=Ddu, nu=Dnu, s=ds,
                        t_ul=dt_ul, l_ul=b_ul - s_ul * dt_ul,
                        t_uu=dt_uu, l_uu=b_uu - s_uu * dt_uu,
                        t_xl=dt_xl, l_xl=b_xl - s_xl * dt_xl,
                        t_xu=dt_xu, l_xu=b_xu - s_xu * dt_xu,
                        t_h=dt_h, l_h=b_h - s_h * dt_h, l_s=b_s - s_s * ds)

        def max_step(pairs, tau_f):
            """Largest a in [0, 1] with v + a dv >= (1 - tau_f) v per row; the
            denominator is substituted only on the unselected branch."""
            a = torch.ones((nb,), **kw)
            for v, dv in pairs:
                neg = dv < 0
                ratio = torch.where(neg, tau_f * v / torch.where(neg, -dv, 1.0), 2.0)
                a = torch.minimum(a, torch.amin(ratio.flatten(1), 1))
            return a

        def prim(D):
            return [(t_ul, D["t_ul"]), (t_uu, D["t_uu"]), (t_xl, D["t_xl"]),
                    (t_xu, D["t_xu"]), (t_h, D["t_h"]), (s, D["s"])]

        def dual(D):
            return [(l_ul, D["l_ul"]), (l_uu, D["l_uu"]), (l_xl, D["l_xl"]),
                    (l_xu, D["l_xu"]), (l_h, D["l_h"]), (l_s, D["l_s"])]

        # ---- predictor (affine scaling) -------------------------------------------
        aff = directions(-l_ul, -l_uu, -l_xl, -l_xu, -l_h, -l_s)
        ap_aff, ad_aff = max_step(prim(aff), 1.0), max_step(dual(aff), 1.0)
        mu_aff = sum(_rsum((t + _bc(ap_aff, t) * dt) * (l + _bc(ad_aff, l) * dl))
                     for (t, dt), (l, dl) in zip(prim(aff), dual(aff))) / n_pairs
        sig_c = torch.clamp((mu_aff / torch.clamp_min(mu, _T_FLOOR)) ** 3, 0.0, 1.0)
        mu_t = sig_c * mu

        # ---- corrector ------------------------------------------------------------
        def beta_c(t, l, dt_a, dl_a):
            return (_bc(mu_t, t) - t * l - dt_a * dl_a) / torch.clamp_min(t, _T_FLOOR)

        cor = directions(*[beta_c(t, l, dt, dl)
                           for (t, dt), (l, dl) in zip(prim(aff), dual(aff))])
        a_p, a_d = max_step(prim(cor), tau), max_step(dual(cor), tau)

        stat = torch.maximum(torch.amax(torch.abs(r_x[:, 1:]).flatten(1), 1),
                             torch.amax(torch.abs(r_u).flatten(1), 1))
        converged = (mu < tol) & (stat < stat_tol)
        # a non-finite direction freezes the row (a select, not a zero step:
        # 0 * inf would make NaNs); every direction component is checked
        finite = torch.isfinite(a_p) & torch.isfinite(a_d)
        for comp in cor.values():
            finite = finite & torch.isfinite(_rsum(comp))
        frozen = converged | ~finite

        def upd(old, a, step, positive=False):
            v = old + _bc(a, old) * step
            if positive:
                v = torch.clamp_min(v, _TINY)
            return torch.where(_bc(frozen, old), old, v)

        dx, du = upd(dx, a_p, cor["dx"]), upd(du, a_p, cor["du"])
        s = upd(s, a_p, cor["s"], True)
        nu_dyn = upd(nu_dyn, a_d, cor["nu"])
        t_ul, l_ul = upd(t_ul, a_p, cor["t_ul"], True), upd(l_ul, a_d, cor["l_ul"], True)
        t_uu, l_uu = upd(t_uu, a_p, cor["t_uu"], True), upd(l_uu, a_d, cor["l_uu"], True)
        t_xl, l_xl = upd(t_xl, a_p, cor["t_xl"], True), upd(l_xl, a_d, cor["l_xl"], True)
        t_xu, l_xu = upd(t_xu, a_p, cor["t_xu"], True), upd(l_xu, a_d, cor["l_xu"], True)
        t_h, l_h = upd(t_h, a_p, cor["t_h"], True), upd(l_h, a_d, cor["l_h"], True)
        l_s = upd(l_s, a_d, cor["l_s"], True)
        # a row that tripped the non-finite guard lowers its own curvature
        # clamp (monotone, one-way) so its next direction is finite
        if sigma_retry:
            sig_cap = torch.where(finite, sig_cap, torch.clamp_max(sig_cap, sigma_retry))
        mus.append(mu)
        stats.append(stat)
        alphas.append(torch.minimum(a_p, a_d))
        sigs.append(sig_c)

    sol = IpSolution(dx=dx, du=du, s=s, mu=mus[-1], kappa=kappa, stat_res=stats[-1])
    if debug:
        return sol, {"mu": torch.stack(mus), "stat": torch.stack(stats),
                     "alpha": torch.stack(alphas), "sigma": torch.stack(sigs)}
    return sol
