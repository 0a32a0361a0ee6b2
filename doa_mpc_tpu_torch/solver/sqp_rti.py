"""SQP real-time-iteration (RTI) controller (``doa_mpc_tpu/solver/sqp_rti.py``).

Per control tick: one Gauss-Newton linearization around the warm-started
guess, one structured QP, a full step. Unlike the JAX package, whose
functions are single-scenario and ``vmap``-ed, :meth:`RtiController.build_qp`
here is written for a leading batch axis B, with the goal and each cost
parameter shared by the batch or given per row (the JAX package's ``vmap``
over them):

- LINEAR_LS cost on (x, y, v, omega, u_a, u_alpha) with W = blkdiag(2 I4,
  0.15 I2), terminal 5 I4, path stages scaled by dt, Levenberg-Marquardt
  ``lm_reg`` inside the scaled stage cost;
- boxes |x|, |y| <= 7 and |v|, |omega| <= 10 on stages 1..N-1, |u| <= 8;
- soft obstacle rows with the distance-scaled, stage-discounted weights
  alpha_i = 1e4 (||sel(x0) - [goal, 0, 0]||^2 + 50) (N - i) / N;
- warm-start shift and the two cold-start strategies;
- :meth:`RtiController.rti_step`, one linearize-solve-step iteration, its
  Newton solves in kernel K2.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from doa_mpc_tpu_torch.config import CostParams, SolverOptions, WorldSpec, resolve_device
from doa_mpc_tpu_torch.models.unicycle import obstacle_h, obstacle_h_jac, safe_dist_sq
from doa_mpc_tpu_torch.ops.integrators import make_integrator, make_linearization
# the structure of every QP build_qp produces, defined beside the kernel
# instantiation that specializes on it
from doa_mpc_tpu_torch.ops.ip_fused import UNICYCLE_QP_STRUCTURE  # noqa: F401
from doa_mpc_tpu_torch.ops.ip_qp import solve_ocp_qp
from doa_mpc_tpu_torch.ops.ocp_qp import (
    BIG_BOUND, IDXBX, OcpQp, gather_idxbx, scatter_idxbx,
)
from doa_mpc_tpu_torch.utils.profiling import span


class RtiState(NamedTuple):
    """Warm-started trajectories: x_traj (..., N+1, nx), u_traj (..., N, nu)."""

    x_traj: torch.Tensor
    u_traj: torch.Tensor


@dataclasses.dataclass(frozen=True)
class RtiController:
    """Bound methods for one RTI configuration."""

    spec: WorldSpec
    options: SolverOptions
    integrate: Callable          # Phi(x, u) over leading batch dims
    lin: Callable                # (xs, us) -> (Phi, A, B) over leading batch dims
    dtype: torch.dtype
    device: torch.device

    def _t(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=self.dtype, device=self.device)

    def cold_start(self, x0) -> RtiState:
        """Every stage at x0 with v, omega zeroed; controls zero. ``x0`` is
        (..., nx)."""
        n = self.spec.n_solv
        xg = self._t(x0).clone()
        xg[..., 3:] = 0.0
        x_traj = xg.unsqueeze(-2).expand(xg.shape[:-1] + (n + 1, xg.shape[-1])).clone()
        u_traj = torch.zeros(xg.shape[:-1] + (n, self.spec.nu),
                             dtype=xg.dtype, device=xg.device)
        return RtiState(x_traj, u_traj)

    def initial_guess(self, x0, goal) -> RtiState:
        """``options.init_guess``: "current" is :meth:`cold_start`;
        "interpolate" reproduces the reference's commented straight-line
        variant with its bugs (x never moves, heading atan2(dy, 0)).
        ``goal`` is (2,) or one per row, (..., 2)."""
        if self.options.init_guess != "interpolate":
            return self.cold_start(x0)
        n = self.spec.n_solv
        x0, goal = self._t(x0), self._t(goal)
        frac = torch.arange(n + 1, dtype=x0.dtype, device=x0.device) / n
        gy = goal[..., 1:2]
        y = x0[..., 1:2] + frac * (gy - x0[..., 1:2])
        psi = torch.atan2(gy - x0[..., 1:2], torch.zeros_like(x0[..., 1:2]))
        ones = torch.ones_like(y)
        zeros = torch.zeros_like(y)
        x_traj = torch.stack([x0[..., 0:1] * ones, y, psi * ones, zeros, zeros], dim=-1)
        u_traj = torch.zeros(x0.shape[:-1] + (n, self.spec.nu),
                             dtype=x0.dtype, device=x0.device)
        return RtiState(x_traj, u_traj)

    def shift(self, state: RtiState) -> RtiState:
        """Stages move one left, the terminal state repeats, the last
        control is zeroed."""
        x = torch.cat([state.x_traj[..., 1:, :], state.x_traj[..., -1:, :]], dim=-2)
        u = torch.cat([state.u_traj[..., 1:, :],
                       torch.zeros_like(state.u_traj[..., :1, :])], dim=-2)
        return RtiState(x, u)

    def build_qp(self, state: RtiState, x0: torch.Tensor, goal: torch.Tensor,
                 obst_traj: torch.Tensor, params: CostParams) -> OcpQp:
        """Gauss-Newton linearization around the guess -> batched OCP QP.

        ``state`` (B, N+1, nx)/(B, N, nu), ``x0`` (B, nx), ``obst_traj`` the
        (B, N+1, M, 2) obstacle forecast. ``goal`` is shared, (2,), or one
        per row, (B, 2); so is each ``params`` leaf: its own shape, or
        (B,) + that shape. A shared input gives the same QP, bit for bit,
        as the same input repeated on every row."""
        with span("doa.build_qp"):
            spec, opts = self.spec, self.options
            n, nx, nu = spec.n_solv, spec.nx, spec.nu
            dt = spec.tf / spec.n_solv
            xg, ug = state.x_traj, state.u_traj
            nb = xg.shape[0]
            kw = dict(dtype=xg.dtype, device=xg.device)

            def rows(leaf, ndim, k):
                """A per-row params leaf with k axes after B, to broadcast over
                (B, <k axes>, ...); a shared leaf as it is."""
                if leaf.ndim == ndim:
                    return leaf
                return leaf.reshape(leaf.shape[:1] + (1,) * k + leaf.shape[1:])

            def with_terminal(path, term, k):
                """Path stages (..., n, <k trailing axes>) and the terminal one
                (..., <k trailing axes>) -> (..., n+1, ...), the shared or per-row
                leading axes broadcast against each other."""
                term = term.unsqueeze(-1 - k)
                lead = torch.broadcast_shapes(path.shape[:-1 - k], term.shape[:-1 - k])
                return torch.cat([path.expand(lead + path.shape[-1 - k:]),
                                  term.expand(lead + term.shape[-1 - k:])], -1 - k)

            with span("doa.linearize"):
                phi, A, Bm = self.lin(xg[:, :-1], ug)
            c = phi - xg[:, 1:]

            sc = torch.full((n + 1,), dt if opts.cost_scale_dt else 1.0, **kw)
            sc[-1:].fill_(1.0)        # `sc[-1] = 1.0` would copy from the host and sync
            w_q = scatter_idxbx(params.q_diag, nx)                 # (nx,) or (B, nx)
            w_qe = scatter_idxbx(params.qe_diag, nx)
            yref = torch.zeros(goal.shape[:-1] + (nx,), **kw)
            yref[..., 0], yref[..., 1] = goal[..., 0], goal[..., 1]
            if goal.ndim == 2:
                yref = yref[:, None]                               # (B, 1, nx)

            lm = params.lm_reg
            lm_sc = sc if opts.lm_scale_dt else torch.ones_like(sc)
            eye_x, eye_u = torch.eye(nx, **kw), torch.eye(nu, **kw)
            Q = (sc[:-1, None, None] * torch.diag_embed(w_q).unsqueeze(-3)
                 + (lm_sc[:-1, None, None] * rows(lm, 0, 3)) * eye_x[None])
            Q_N = torch.diag_embed(w_qe) + rows(lm, 0, 2) * eye_x
            Q = with_terminal(Q, Q_N, 2).expand(nb, n + 1, nx, nx)
            w_stage = with_terminal(w_q.unsqueeze(-2).expand(w_q.shape[:-1] + (n, nx)), w_qe, 1)
            q = sc[:, None] * (w_stage * (xg - yref))

            R = (sc[:-1, None, None] * torch.diag_embed(params.r_diag).unsqueeze(-3)
                 + (lm_sc[:-1, None, None] * rows(lm, 0, 3)) * eye_u[None]).expand(nb, n, nu, nu)
            r = sc[:-1, None] * rows(params.r_diag, 1, 1) * ug
            S = torch.zeros((nb, n, nu, nx), **kw)

            u_bound = rows(params.u_bound, 0, 2)
            lb_u = -u_bound - ug
            ub_u = u_bound - ug
            lo = torch.stack(torch.broadcast_tensors(-params.x_bound, -params.x_bound,
                                                     -params.v_bound, -params.v_bound), -1)
            xg_sel = gather_idxbx(xg)
            lb_x = (rows(lo, 1, 1) - xg_sel).clone()
            ub_x = (-rows(lo, 1, 1) - xg_sel).clone()
            for k in (0, n):          # stage 0 is the x0 equality, stage N has no box
                lb_x[:, k] = -BIG_BOUND
                ub_x[:, k] = BIG_BOUND

            hval = obstacle_h(xg, obst_traj, safe_dist_sq(spec))
            C = obstacle_h_jac(xg, obst_traj)

            goal4 = torch.zeros(goal.shape[:-1] + (len(IDXBX),), **kw)
            goal4[..., 0], goal4[..., 1] = goal[..., 0], goal[..., 1]
            scale = params.slack_scale * (
                torch.sum((gather_idxbx(x0) - goal4) ** 2, dim=-1) + params.slack_offset)
            stage_idx = torch.arange(n + 1, **kw)
            alpha = scale[:, None] * (n - stage_idx) / n          # alpha_N = 0
            slack_sc = sc if opts.slack_scale_dt else torch.ones_like(sc)
            zl = (slack_sc[None, :, None] * alpha[:, :, None]).expand(nb, n + 1, spec.n_obst)

            return OcpQp(A=A, B=Bm, c=c, dx0=x0 - xg[:, 0], Q=Q, q=q, R=R, r=r, S=S,
                         lb_u=lb_u, ub_u=ub_u, lb_x=lb_x, ub_x=ub_x,
                         C=C, hval=hval, zl=zl, Zl=zl)

    def rti_step(self, state: RtiState, x0: torch.Tensor, goal: torch.Tensor,
                 obst_traj: torch.Tensor, params: CostParams):
        """One real-time iteration for a batch: linearize -> QP -> full step.
        ``goal`` and ``params`` are shared or per row, as in :meth:`build_qp`.

        The JAX package's single-scenario step solves with its XLA
        interior-point solver at ``options.ip_reg`` and with ``sigma_retry``.
        Its counterpart here is :func:`ops.ip_qp.solve_ocp_qp`, which this
        step calls with backend ``"riccati"``: each Newton solve is one
        launch of kernel K2 on CUDA tensors (its plain version on CPU
        tensors), two per IP iteration. Kernel K1 would change the result:
        it has no ``sigma_retry``, runs at the solver's default ``reg`` and
        associates its step length differently. Unlike the batched tick,
        which leaves ``reg`` at the solver's default, this step passes
        ``options.ip_reg``. Returns (new_state, u0 (B, nu), solution); u0 is
        the control applied to the plant."""
        qp = self.build_qp(state, x0, goal, obst_traj, params)
        with span("doa.solve"):
            sol = solve_ocp_qp(qp, iters=self.options.qp_iter, tau=self.options.ip_tau,
                               reg=self.options.ip_reg, backend="riccati")
        new = RtiState(x_traj=state.x_traj + sol.dx, u_traj=state.u_traj + sol.du)
        return new, new.u_traj[:, 0], sol


def make_rti_controller(spec: WorldSpec, options: SolverOptions | None = None,
                        dtype=torch.float32, device="cuda") -> RtiController:
    options = options or SolverOptions(qp_iter=spec.qp_iter)
    dev = resolve_device(device)
    step = make_integrator(options)
    linearize = make_linearization(options)
    dt = spec.tf / spec.n_solv

    def integrate(x, u):
        return step(x, u, dt)

    def lin(xs, us):
        """(Phi, dPhi/dx, dPhi/du) over (..., nx)/(..., nu) stage arrays: the
        stage points as one batch of rows (for IRK one Newton solve per
        iteration and one for the sensitivities, whatever the row count)."""
        lead = xs.shape[:-1]
        phi, A, B = linearize(xs.reshape(-1, xs.shape[-1]), us.reshape(-1, us.shape[-1]), dt)
        return (phi.reshape(xs.shape), A.reshape(lead + A.shape[1:]),
                B.reshape(lead + B.shape[1:]))

    return RtiController(spec=spec, options=options, integrate=integrate,
                         lin=lin, dtype=dtype, device=dev)
