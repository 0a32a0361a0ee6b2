"""The plain reference of one closed-loop RTI control tick.

Plain PyTorch on batch-first tensors, in whatever dtype its inputs carry
(the check runs it in float64, the control in bfloat16). It imports nothing
of the program: it is written from the semantics of the upstream controller
(acados RTI with LINEAR_LS cost, soft obstacle rows, a fixed IP budget) as
the program states them, and it derives everything itself from the inputs
the benchmark hands both sides (the loop state before the tick, the goal,
the cost parameters, the obstacle noise).

A loop state is a dict of tensors: ``x0`` (B, 5), ``x_traj`` (B, N+1, 5),
``u_traj`` (B, N, 2), ``pos``/``vel`` (B, M, 2), ``done``/``reached``/
``oob`` (B,) bool, ``min_margin``/``dist`` (B,), ``steps``/``resets`` (B,)
int32. ``world`` is the configuration's ``world`` block and ``solver`` its
``solver`` block (plain dicts).

Per tick: forecast the obstacles (the closed-form bounce fold), linearize
the dynamics at the warm start (rk4 by forward-mode Jacobians; IRK by the
implicit-function theorem at the converged stage states), assemble the QP,
solve it (:mod:`mpcbench.reference.ip`), apply u0 to the plant, step the
obstacles with the given noise, update the metrics, shift the warm start and
freeze the rows that were done.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.func import jacfwd, vmap

from mpcbench.reference import ip

IDXBX = (0, 1, 3, 4)
BIG_BOUND = 1e6
STATE_KEYS = ("x0", "x_traj", "u_traj", "pos", "vel", "done", "reached", "oob",
              "min_margin", "dist", "steps", "resets")


def dt_of(world) -> float:
    return world["tf"] / world["n_solv"]


# ---------------------------------------------------------------------------
# model and obstacle world
# ---------------------------------------------------------------------------

def dynamics(s, u):
    """Unicycle: x' = v cos psi, y' = v sin psi, psi' = omega, v' = u_a,
    omega' = u_alpha."""
    v, psi = s[..., 3], s[..., 2]
    return torch.stack([v * torch.cos(psi), v * torch.sin(psi), s[..., 4],
                        u[..., 0], u[..., 1]], -1)


def forecast(pos, vel, world, n, pred_bug):
    """Noise-free n-step obstacle forecast (B, n+1, M, 2): the specular
    bounce sampled at k dt, as the fold of the free path into the box. With
    ``pred_bug`` the forecast uses vy for both axes (the upstream typo)."""
    if pred_bug:
        vel = torch.stack([vel[..., 1], vel[..., 1]], -1)
    lo = torch.tensor([world["x_min"], world["y_min"]], dtype=pos.dtype, device=pos.device)
    hi = torch.tensor([world["x_max"], world["y_max"]], dtype=pos.dtype, device=pos.device)
    t = torch.arange(n + 1, dtype=pos.dtype, device=pos.device) * dt_of(world)
    free = (pos - lo)[:, None] + t[None, :, None, None] * vel[:, None]
    period = 2.0 * (hi - lo)
    y = torch.remainder(free, period)
    return lo + torch.minimum(y, period - y)


def _bounce(p, v, dt, lo, hi):
    speed = torch.clamp_min(torch.abs(v), 1e-30)
    t_hit = torch.where(v < 0, (p - lo) / speed,
                        torch.where(v > 0, (hi - p) / speed, torch.full_like(p, math.inf)))
    hit = t_hit <= dt
    return (torch.where(hit, p + v * t_hit - v * (dt - t_hit), p + v * dt),
            torch.where(hit, -v, v))


def obstacle_step(pos, vel, noise, world):
    """Velocities scaled by (1 + randomness noise) and clamped to the
    obstacle speed limit (``noise`` None: no noise), then one exact
    wall-reflecting step."""
    if noise is not None:
        vel = torch.clamp((1.0 + world["randomness"] * noise) * vel,
                          -world["v_max_obst"], world["v_max_obst"])
    dt = dt_of(world)
    px, vx = _bounce(pos[..., 0], vel[..., 0], dt, world["x_min"], world["x_max"])
    py, vy = _bounce(pos[..., 1], vel[..., 1], dt, world["y_min"], world["y_max"])
    return torch.stack([px, py], -1), torch.stack([vx, vy], -1)


# ---------------------------------------------------------------------------
# integrators and the linearization
# ---------------------------------------------------------------------------

def rk4(x, u, dt):
    k1 = dynamics(x, u)
    k2 = dynamics(x + 0.5 * dt * k1, u)
    k3 = dynamics(x + 0.5 * dt * k2, u)
    k4 = dynamics(x + dt * k3, u)
    return x + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


def gauss_legendre(stages: int):
    """(A, b) of the s-stage Gauss-Legendre collocation method."""
    xs, _ = np.polynomial.legendre.leggauss(stages)
    c = (xs + 1.0) / 2.0
    A, b = np.zeros((stages, stages)), np.zeros(stages)
    for j in range(stages):
        poly = np.poly1d([1.0])
        for k in range(stages):
            if k != j:
                poly *= np.poly1d([1.0, -c[k]]) / (c[j] - c[k])
        integ = poly.integ()
        b[j] = integ(1.0) - integ(0.0)
        for i in range(stages):
            A[i, j] = integ(c[i]) - integ(0.0)
    return A, b


def _stage_jac(Z, u, argnums):
    """Jacobians of the dynamics at each stage state Z (R, s, nx)."""
    R, s, nx = Z.shape
    ub = u[:, None].expand(R, s, u.shape[-1])
    jac = vmap(jacfwd(dynamics, argnums=argnums))(Z.reshape(-1, nx), ub.reshape(R * s, -1))
    return [J.reshape(R, s, nx, -1) for J in jac]


def _newton_matrix(Jf, A, h):
    """The dense collocation Newton matrix I - h (A (x) Jf) over rows,
    (R, s nx, s nx), block (i, j) = delta_ij I - h A_ij Jf_i."""
    R, s, nx, _ = Jf.shape
    blocks = -h * A[None, :, :, None, None] * Jf[:, :, None]
    blocks = blocks + torch.eye(s, dtype=Jf.dtype, device=Jf.device)[None, :, :, None, None] \
        * torch.eye(nx, dtype=Jf.dtype, device=Jf.device)
    return blocks.permute(0, 1, 3, 2, 4).reshape(R, s * nx, s * nx)


def _solve(M, rhs):
    """M X = rhs by Gaussian elimination on the rows (no library solver, so
    any dtype works, bfloat16 included; pivoting is not needed: M is close
    to the identity)."""
    n = M.shape[-1]
    aug = torch.cat([M, rhs], -1)
    for k in range(n):
        row = aug[:, k] / aug[:, k, k:k + 1]
        aug = aug - aug[:, :, k:k + 1] * row[:, None]
        aug[:, k] = row
    return aug[:, :, n:]


def irk(x, u, dt, solver, sensitivities):
    """One Gauss-Legendre collocation step with a fixed number of full
    Newton iterations from K_i = f(x, u); with ``sensitivities`` also
    D = dPhi/d(x, u) (R, nx, nx + nu) by the implicit-function theorem at
    the converged stage states."""
    if solver["irk_tableau"] != "gauss_legendre":
        raise NotImplementedError("the reference integrates Gauss-Legendre tableaus")
    s = solver["irk_stages"]
    An, bn = gauss_legendre(s)
    A = torch.tensor(An, dtype=x.dtype, device=x.device)
    b = torch.tensor(bn, dtype=x.dtype, device=x.device)
    R, nx = x.shape
    K = dynamics(x, u)[:, None].expand(R, s, nx)
    for _ in range(solver["irk_newton_iter"]):
        Z = x[:, None] + dt * torch.einsum("ij,rjn->rin", A, K)
        res = K - dynamics(Z, u[:, None].expand(R, s, u.shape[-1]))
        (Jf,) = _stage_jac(Z, u, (0,))
        step = _solve(_newton_matrix(Jf, A, dt), res.reshape(R, s * nx, 1))
        K = K - step.reshape(R, s, nx)
    phi = x + dt * torch.einsum("j,rjn->rn", b, K)
    if not sensitivities:
        return phi
    Z = x[:, None] + dt * torch.einsum("ij,rjn->rin", A, K)
    Jf, Ju = _stage_jac(Z, u, (0, 1))
    rhs = torch.cat([Jf, Ju], -1).reshape(R, s * nx, -1)
    dK = _solve(_newton_matrix(Jf, A, dt), rhs).reshape(R, s, nx, -1)
    eye = torch.eye(nx, nx + u.shape[-1], dtype=x.dtype, device=x.device)
    return phi, eye + dt * torch.einsum("j,rjab->rab", b, dK)


def integrate(x, u, dt, solver):
    if solver["integrator"] == "rk4":
        return rk4(x, u, dt)
    return irk(x, u, dt, solver, False)


def linearize(xs, us, dt, solver):
    """(Phi, dPhi/dx, dPhi/du) over rows xs (R, nx), us (R, nu)."""
    if solver["integrator"] == "irk":
        phi, D = irk(xs, us, dt, solver, True)
        return phi, D[..., :xs.shape[-1]], D[..., xs.shape[-1]:]

    def twice(x, u):
        p = rk4(x, u, dt)
        return p, p

    (A, B), phi = vmap(jacfwd(twice, argnums=(0, 1), has_aux=True))(xs, us)
    return phi, A, B


# ---------------------------------------------------------------------------
# the QP of one real-time iteration
# ---------------------------------------------------------------------------

def _per_row(v, nb, tail):
    """A cost parameter shared (shape ``tail``) or per row ((B,) + tail) as
    (B,) + tail."""
    v = torch.as_tensor(v)
    return v.expand((nb,) + tuple(tail)) if v.ndim == len(tail) else v


def build_qp(st, goal, obst_traj, params, world, solver):
    """The Gauss-Newton QP around the warm start (an ``ip.Qp``). ``goal`` is
    (2,) or (B, 2); each ``params`` value is shared or per row."""
    xg, ug, x0 = st["x_traj"], st["u_traj"], st["x0"]
    nb, n1, nx = xg.shape
    n, nu, M = n1 - 1, ug.shape[-1], obst_traj.shape[-2]
    dt = dt_of(world)
    kw = dict(dtype=xg.dtype, device=xg.device)
    P = {k: _per_row(torch.as_tensor(v).to(**kw), nb,
                     (4,) if k in ("q_diag", "qe_diag") else (2,) if k == "r_diag" else ())
         for k, v in params.items()}
    goal = goal.expand(nb, 2)

    phi, A, B = linearize(xg[:, :-1].reshape(-1, nx), ug.reshape(-1, nu), dt, solver)
    A, B = A.reshape(nb, n, nx, nx), B.reshape(nb, n, nx, nu)
    c = phi.reshape(nb, n, nx) - xg[:, 1:]

    sc = torch.full((n1,), dt if solver["cost_scale_dt"] else 1.0, **kw)
    sc[-1] = 1.0
    lm_sc = sc if solver["lm_scale_dt"] else torch.ones_like(sc)
    sel = list(IDXBX)
    w_q = torch.zeros(nb, nx, **kw)
    w_q[:, sel] = P["q_diag"]
    w_qe = torch.zeros(nb, nx, **kw)
    w_qe[:, sel] = P["qe_diag"]
    lm = P["lm_reg"]
    eye_x, eye_u = torch.eye(nx, **kw), torch.eye(nu, **kw)
    Qp = (sc[None, :-1, None, None] * torch.diag_embed(w_q)[:, None]
          + (lm_sc[None, :-1] * lm[:, None])[..., None, None] * eye_x)
    QN = torch.diag_embed(w_qe) + lm[:, None, None] * eye_x
    Q = torch.cat([Qp, QN[:, None]], 1)
    yref = torch.zeros(nb, 1, nx, **kw)
    yref[:, 0, :2] = goal
    w_stage = torch.cat([w_q[:, None].expand(nb, n, nx), w_qe[:, None]], 1)
    q = sc[None, :, None] * (w_stage * (xg - yref))
    R = (sc[None, :-1, None, None] * torch.diag_embed(P["r_diag"])[:, None]
         + (lm_sc[None, :-1] * lm[:, None])[..., None, None] * eye_u)
    r = sc[None, :-1, None] * P["r_diag"][:, None] * ug
    S = torch.zeros(nb, n, nu, nx, **kw)

    ub = P["u_bound"][:, None, None]
    lb_u, ub_u = -ub - ug, ub - ug
    hi = torch.stack([P["x_bound"], P["x_bound"], P["v_bound"], P["v_bound"]], -1)[:, None]
    xsel = xg[..., sel]
    lb_x, ub_x = (-hi - xsel).clone(), (hi - xsel).clone()
    for k in (0, n):
        lb_x[:, k], ub_x[:, k] = -BIG_BOUND, BIG_BOUND

    safe = (world["r_obst"] + world["r_robot"] + world["margin"]) ** 2
    d = xg[:, :, None, :2] - obst_traj
    hval = (d * d).sum(-1) - safe
    C = torch.cat([2.0 * d, torch.zeros(d.shape[:-1] + (nx - 2,), **kw)], -1)

    goal4 = torch.zeros(nb, 4, **kw)
    goal4[:, :2] = goal
    scale = P["slack_scale"] * (((x0[:, sel] - goal4) ** 2).sum(-1) + P["slack_offset"])
    alpha = scale[:, None] * (n - torch.arange(n1, **kw)) / n
    slack_sc = sc if solver["slack_scale_dt"] else torch.ones_like(sc)
    zl = (slack_sc[None, :, None] * alpha[:, :, None]).expand(nb, n1, M)
    return ip.Qp(A=A, B=B, c=c, dx0=x0 - xg[:, 0], Q=Q, q=q, R=R, r=r, S=S,
                 lb_u=lb_u, ub_u=ub_u, lb_x=lb_x, ub_x=ub_x, C=C, hval=hval, zl=zl, Zl=zl)


# ---------------------------------------------------------------------------
# the tick
# ---------------------------------------------------------------------------

def cold_start(x0, n):
    """Every stage at x0 with v and omega zeroed; controls zero."""
    xg = x0.clone()
    xg[:, 3:] = 0.0
    return (xg[:, None].expand(x0.shape[0], n + 1, x0.shape[1]).clone(),
            torch.zeros(x0.shape[0], n, 2, dtype=x0.dtype, device=x0.device))


def init_state(x_init, goal, pos, vel, world):
    """A fresh batch: the plant at ``x_init`` (5,), the given obstacles,
    a cold-started warm start, cleared metrics."""
    nb = pos.shape[0]
    x0 = x_init.to(pos.dtype).expand(nb, 5).clone()
    x_traj, u_traj = cold_start(x0, world["n_solv"])
    flags = torch.zeros(nb, dtype=torch.bool, device=pos.device)
    ints = torch.zeros(nb, dtype=torch.int32, device=pos.device)
    return dict(x0=x0, x_traj=x_traj, u_traj=u_traj, pos=pos.clone(), vel=vel.clone(),
                done=flags, reached=flags.clone(), oob=flags.clone(),
                min_margin=torch.full((nb,), math.inf, dtype=pos.dtype, device=pos.device),
                dist=torch.linalg.norm(x0[:, :2] - goal.to(pos.dtype), dim=-1),
                steps=ints, resets=ints.clone())


def tick(st, goal, params, noise, world, solver):
    """One closed-loop tick of every row, solved as the batched tick solves
    (the whole-solve formulas at the solver's default regularization).
    Returns the new loop state."""
    if solver["init_guess_when_error"] or solver["init_guess"] != "current":
        raise NotImplementedError("the reference has no status-4 analogue or interpolated "
                                  "initial guess")
    n = world["n_solv"]
    goal = goal.to(st["x0"].dtype)
    pred = forecast(st["pos"], st["vel"], world, n, solver["compat_pred_bug"])
    qp = build_qp(st, goal, pred, params, world, solver)
    dx, du = ip.solve_k1(qp, solver["qp_iter"], solver["ip_tau"])
    x_traj, u_traj = st["x_traj"] + dx, st["u_traj"] + du
    u0 = u_traj[:, 0]

    x_new = integrate(st["x0"], u0, dt_of(world), solver)
    pos, vel = obstacle_step(st["pos"], st["vel"], noise, world)
    oob = st["oob"] | (x_new[:, 0].abs() > world["x_max"]) | (x_new[:, 1].abs() > world["y_max"])
    gap = torch.linalg.norm(x_new[:, None, :2] - pos, dim=-1) - (world["r_obst"] + world["r_robot"])
    margin = torch.minimum(st["min_margin"], gap.amin(-1))
    dist = torch.linalg.norm(x_new[:, :2] - goal, dim=-1)
    reached = dist <= world["tol"]
    new = dict(
        x0=x_new,
        x_traj=torch.cat([x_traj[:, 1:], x_traj[:, -1:]], 1),
        u_traj=torch.cat([u_traj[:, 1:], torch.zeros_like(u_traj[:, :1])], 1),
        pos=pos, vel=vel, done=st["done"] | reached, reached=st["reached"] | reached,
        oob=oob, min_margin=margin, dist=dist,
        steps=st["steps"] + (~reached).to(torch.int32), resets=st["resets"])
    return {k: torch.where(st["done"].reshape((-1,) + (1,) * (v.ndim - 1)), st[k], v)
            for k, v in new.items()}
