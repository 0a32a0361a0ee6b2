"""Batched closed-loop RTI simulation (``doa_mpc_tpu/sim/closed_loop.py``).

Per tick, for every scenario of the batch at once:

1. forecast the obstacles (closed-form bounce fold),
2. linearize and assemble the QPs (``RtiController.build_qp``),
3. solve all QPs in one call (kernel K1, ``ops/ip_fused.py``, or the
   interior-point solver of ``ops/ip_qp.py``),
4. take the full step and apply u0 to the plant, stepped by the
   controller's integrator (``ctrl.integrate``; with the status-4
   analogue on, rows whose solve failed reset their warm start first),
5. step the obstacles, with velocity noise unless ``random_move`` is off,
6. update min-margin / out-of-bounds / goal metrics, shift the warm start,
   and freeze rows that are done (every field of the state, as the
   reference's ``break`` does).

Two families of ticks do this. The batched tick (``make_batched_tick``,
the Monte-Carlo main path) closes over one goal and chooses its solver
backend. The parametric tick (``make_parametric_tick``, with ``make_tick``
and ``make_rollout`` on top) is the counterpart of the JAX package's
single-scenario tick under ``vmap``: it takes the goal and the cost
parameters per call, shared or per row, and solves through
``RtiController.rti_step`` (kernel K2 on the card).

The reference keeps simulating after a collision; ``hit`` is judged from
``min_margin <= 0`` afterwards. The status-4 reset analogue
(``SolverOptions.init_guess_when_error``) is off by default.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from doa_mpc_tpu_torch.config import CostParams
from doa_mpc_tpu_torch.ops.ip_fused import UNICYCLE_QP_STRUCTURE, solve_ocp_qp_fused
from doa_mpc_tpu_torch.ops.ip_qp import IpSolution, solve_ocp_qp
from doa_mpc_tpu_torch.sim.obstacles import (
    ObstacleState, generate_obstacles, obstacle_step, predict_trajectory,
)
from doa_mpc_tpu_torch.solver.sqp_rti import RtiController, RtiState
from doa_mpc_tpu_torch.utils.profiling import keep, span

BACKENDS = ("fused", "torch", "riccati", "zero")


class LoopState(NamedTuple):
    """Carried per-scenario closed-loop state, batch-first (B, ...). The JAX
    package's per-row PRNG ``key`` has no counterpart: noise comes from a
    ``torch.Generator`` or a precomputed stream."""

    x0: torch.Tensor          # (B, nx) plant state
    rti: RtiState             # warm-started trajectories
    obst: ObstacleState       # obstacle world
    done: torch.Tensor        # (B,) bool — goal reached, row frozen
    reached: torch.Tensor     # (B,) bool
    oob: torch.Tensor         # (B,) bool — ever left the grid
    min_margin: torch.Tensor  # (B,) running min margin to any obstacle
    dist: torch.Tensor        # (B,) last distance to goal
    steps: torch.Tensor       # (B,) int32
    resets: torch.Tensor      # (B,) int32 — status-4 analogue firings


class LoopMetrics(NamedTuple):
    """The 6-column result row of the reference's experiments CSV."""

    hit: torch.Tensor
    reached: torch.Tensor
    min_margin: torch.Tensor
    dist: torch.Tensor
    steps: torch.Tensor
    oob: torch.Tensor


def metrics_of(state: LoopState) -> LoopMetrics:
    return LoopMetrics(hit=(state.min_margin <= 0.0), reached=state.reached,
                       min_margin=state.min_margin, dist=state.dist,
                       steps=state.steps, oob=state.oob)


def init_loop_state(ctrl: RtiController, x_init, goal, scenario: str = "RANDOM",
                    batch_shape=(1,), obst: ObstacleState | None = None,
                    generator: torch.Generator | None = None) -> LoopState:
    """Fresh batch of experiments on ``ctrl.device``, ``batch_shape`` = (B,)
    (one batch axis): obstacles
    (``obst`` pins them, e.g. the compat_rng worlds; otherwise sampled from
    ``generator``), cold-started solver, cleared metrics."""
    (batch,) = batch_shape
    dev, dtype = ctrl.device, ctrl.dtype
    kw = dict(dtype=dtype, device=dev)
    x_init = torch.as_tensor(x_init, **kw).expand(batch, ctrl.spec.nx).clone()
    goal = torch.as_tensor(goal, **kw)
    if obst is None:
        obst = generate_obstacles(generator, ctrl.spec, scenario, (batch,),
                                  dtype=dtype, device=dev)
    else:
        obst = ObstacleState(pos=torch.as_tensor(obst.pos, **kw),
                             vel=torch.as_tensor(obst.vel, **kw))
    flags = torch.zeros((batch,), dtype=torch.bool, device=dev)
    ints = torch.zeros((batch,), dtype=torch.int32, device=dev)
    return LoopState(
        x0=x_init, rti=ctrl.initial_guess(x_init, goal), obst=obst,
        done=flags, reached=flags.clone(), oob=flags.clone(),
        min_margin=torch.full((batch,), float("inf"), **kw),
        dist=torch.linalg.norm(x_init[:, :2] - goal, dim=-1),
        steps=ints, resets=ints.clone())


def _freeze(done, old, new):
    """``new`` where the row is still running, ``old`` where it is done."""
    return torch.where(done.reshape(done.shape + (1,) * (new.ndim - 1)), old, new)


def _advance(ctrl: RtiController, st: LoopState, rti_new: RtiState, u0, sol, goal,
             random_move: bool, noise, generator):
    """The tick after the solve, shared by the batched and the parametric
    tick: the status-4 analogue, the plant, the world, the metrics against
    ``goal`` ((2,) or (B, 2)), the shift and the freeze. Returns the new
    state and ``rti_new`` after any status-4 reset (the pre-shift horizon)."""
    with span("doa.advance"):
        spec, opts = ctrl.spec, ctrl.options
        # status-4 analogue: rows whose solve did not converge reset their warm
        # start and (compat_brake_bug) brake the plant; the failed u0 is still
        # applied this tick
        x0_eff, resets = st.x0, st.resets
        if opts.init_guess_when_error:
            fail = ~((sol.mu < opts.fail_mu_tol) & (sol.stat_res < opts.fail_stat_tol))
            if opts.compat_brake_bug and opts.init_guess != "interpolate":
                braked = torch.cat([st.x0[:, :3], torch.zeros_like(st.x0[:, 3:])], 1)
                x0_eff = torch.where(fail[:, None], braked, st.x0)
            reset = ctrl.initial_guess(x0_eff, goal)
            rti_new = RtiState(*(torch.where(fail.reshape(-1, 1, 1), a, b)
                                 for a, b in zip(reset, rti_new)))
            resets = st.resets + fail.to(torch.int32)

        with span("doa.integrate"):
            x_new = ctrl.integrate(x0_eff, u0)
        obst_new = obstacle_step(st.obst, spec, random_move=random_move, noise=noise,
                                 generator=generator)

        oob = (st.oob | (torch.abs(x_new[:, 0]) > spec.x_max)
               | (torch.abs(x_new[:, 1]) > spec.y_max))
        d = x_new[:, None, :2] - obst_new.pos
        margin = torch.amin(torch.linalg.norm(d, dim=-1)
                            - (spec.r_obst + spec.r_robot), dim=-1)
        min_margin = torch.minimum(st.min_margin, margin)
        dist = torch.linalg.norm(x_new[:, :2] - goal, dim=-1)
        reached = dist <= spec.tol
        steps = st.steps + (~reached).to(torch.int32)
        rti_shifted = ctrl.shift(rti_new)

        new = LoopState(
            x0=x_new, rti=rti_shifted, obst=obst_new,
            done=st.done | reached, reached=st.reached | reached,
            oob=oob, min_margin=min_margin, dist=dist, steps=steps,
            resets=resets)
        frozen = LoopState(
            x0=_freeze(st.done, st.x0, new.x0),
            rti=RtiState(*(_freeze(st.done, o, u) for o, u in zip(st.rti, new.rti))),
            obst=ObstacleState(*(_freeze(st.done, o, u) for o, u in zip(st.obst, new.obst))),
            **{f: _freeze(st.done, getattr(st, f), getattr(new, f))
               for f in LoopState._fields[3:]})
        return frozen, rti_new


def make_batched_tick(ctrl: RtiController, goal, params: CostParams,
                      random_move: bool = True, backend: str = "fused",
                      generator: torch.Generator | None = None):
    """The natively batched control tick.

    Backends:

    - ``'fused'``: the whole interior-point solve in one launch of kernel K1,
      its unicycle instantiation (its plain version for CPU tensors), which
      skips the done rows: their answer is zeros, and the freeze discards it;
    - ``'torch'``: ``ops/ip_qp.solve_ocp_qp`` with the plain Riccati sweep
      (the JAX package's ``'xla'``);
    - ``'riccati'``: the same solver with each Newton solve in kernel K2
      (the JAX package's ``'pallas'``);
    - ``'zero'``: skips the solve (a zero step), a profiling aid that leaves
      only the tick's glue to time.

    ``generator`` draws the obstacle noise when a tick is called without
    ``noise``; without ``random_move`` the obstacles bounce noise-free."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} is not ported; choose from {BACKENDS}")
    spec, opts = ctrl.spec, ctrl.options
    n = spec.n_solv
    goal = torch.as_tensor(goal, dtype=ctrl.dtype, device=ctrl.device)

    def tick(st: LoopState, noise: torch.Tensor | None = None) -> LoopState:
        """One tick; ``noise`` is an optional (B, M, 2) standard-normal draw
        (the compat_rng stream)."""
        with span("doa.tick", tick=True):
            with span("doa.forecast"):
                pred = predict_trajectory(st.obst, spec, n,
                                          compat_pred_bug=opts.compat_pred_bug)
                pred = pred.movedim(0, 1)                      # (B, N+1, M, 2)
            qp = ctrl.build_qp(st.rti, st.x0, goal, pred, params)

            with span("doa.solve"):
                if backend == "fused":
                    # the i-th kept ``done`` belongs to the i-th K1 launch
                    keep("tick.done", st.done)
                    # build_qp's QPs carry the unicycle structure, as in the JAX
                    # tick; done rows are frozen below, so K1 skips their solve
                    sol = solve_ocp_qp_fused(qp, iters=opts.qp_iter, tau=opts.ip_tau,
                                             structure=UNICYCLE_QP_STRUCTURE, skip=st.done)
                elif backend != "zero":
                    # no ``reg``: the solver's dtype default (1e-6 in f32), as the
                    # JAX package's batched tick does
                    sol = solve_ocp_qp(qp, iters=opts.qp_iter, tau=opts.ip_tau,
                                       backend=backend)
                else:
                    nb = st.x0.shape[0]
                    zeros = torch.zeros((nb,), dtype=st.x0.dtype, device=st.x0.device)
                    sol = IpSolution(dx=torch.zeros_like(st.rti.x_traj),
                                     du=torch.zeros_like(st.rti.u_traj),
                                     s=torch.zeros_like(qp.hval), mu=zeros,
                                     kappa=torch.ones_like(zeros), stat_res=zeros)
            rti_new = RtiState(x_traj=st.rti.x_traj + sol.dx,
                               u_traj=st.rti.u_traj + sol.du)
            u0 = rti_new.u_traj[:, 0]
            return _advance(ctrl, st, rti_new, u0, sol, goal, random_move, noise,
                            generator)[0]

    return tick


def make_batched_rollout(ctrl: RtiController, goal, params: CostParams,
                         max_iter: int = 400, random_move: bool = True,
                         backend: str = "fused", collect: bool = False,
                         use_noise_traj: bool = False,
                         generator: torch.Generator | None = None):
    """Run the batched tick ``max_iter`` times (a Python loop over ticks).

    With ``use_noise_traj`` the rollout takes a second argument, the
    ``(max_iter, B, M, 2)`` noise stream, one slice per tick. With
    ``collect`` it returns ``(final, (x0, obst_pos))``, the states after
    each tick stacked as (T, B, nx) and (T, B, M, 2)."""
    tick = make_batched_tick(ctrl, goal, params, random_move=random_move,
                             backend=backend, generator=generator)

    def rollout(st: LoopState, noise_traj: torch.Tensor | None = None):
        xs, ps = [], []
        for i in range(max_iter):
            st = tick(st, noise=None if noise_traj is None else noise_traj[i])
            if collect:
                xs.append(st.x0)
                ps.append(st.obst.pos)
        if collect:
            return st, (torch.stack(xs), torch.stack(ps))
        return st

    if use_noise_traj:
        return rollout
    return lambda st: rollout(st, None)


def make_parametric_tick(ctrl: RtiController, random_move: bool = True,
                         return_pred: bool = False,
                         generator: torch.Generator | None = None):
    """The tick with the goal and the cost parameters as arguments, for B
    rows at once (the JAX package's single-scenario tick under ``vmap``).

    ``tick(st, goal, params, noise=None)``: ``goal`` is (2,) or one per row,
    (B, 2), the subgoal interface the RL layer retargets every step;
    ``params`` is shared or per row (``RtiController.build_qp``). It
    solves with :meth:`RtiController.rti_step` (kernel K2 on CUDA tensors,
    at ``options.ip_reg``). ``noise`` is as in :func:`make_batched_tick`;
    without it the draw comes from ``generator``. With ``return_pred`` the
    tick also returns this tick's solved state horizon, (B, N+1, nx), before
    the shift."""
    spec, opts = ctrl.spec, ctrl.options
    n = spec.n_solv

    def tick(st: LoopState, goal, params: CostParams,
             noise: torch.Tensor | None = None):
        with span("doa.tick", tick=True):
            goal = torch.as_tensor(goal, dtype=ctrl.dtype, device=ctrl.device)
            with span("doa.forecast"):
                pred = predict_trajectory(st.obst, spec, n,
                                          compat_pred_bug=opts.compat_pred_bug).movedim(0, 1)
            rti_new, u0, sol = ctrl.rti_step(st.rti, st.x0, goal, pred, params)
            frozen, rti_new = _advance(ctrl, st, rti_new, u0, sol, goal, random_move, noise,
                                       generator)
        if return_pred:
            return frozen, rti_new.x_traj
        return frozen

    return tick


def make_tick(ctrl: RtiController, goal, params: CostParams,
              random_move: bool = True, return_pred: bool = False,
              generator: torch.Generator | None = None):
    """The fixed-goal tick: :func:`make_parametric_tick` with ``goal`` and
    ``params`` bound; ``tick(st, noise=None)``."""
    goal = torch.as_tensor(goal, dtype=ctrl.dtype, device=ctrl.device)
    ptick = make_parametric_tick(ctrl, random_move=random_move,
                                 return_pred=return_pred, generator=generator)

    def tick(st: LoopState, noise: torch.Tensor | None = None):
        return ptick(st, goal, params, noise=noise)

    return tick


def make_rollout(ctrl: RtiController, goal, params: CostParams,
                 max_iter: int = 400, random_move: bool = True,
                 collect: bool = False, generator: torch.Generator | None = None):
    """Run :func:`make_tick` ``max_iter`` times (the reference's 400-step
    experiment). With ``collect`` it returns ``(final, (x0, obst_pos,
    pred_x))``: the state after each tick and the tick's solved horizon,
    stacked as (T, B, nx), (T, B, M, 2) and (T, B, N+1, nx), for
    visualization (``utils/viz.py``) and tests."""
    tick = make_tick(ctrl, goal, params, random_move=random_move,
                     return_pred=collect, generator=generator)

    def rollout(st: LoopState):
        xs, ps, preds = [], [], []
        for _ in range(max_iter):
            if collect:
                st, pred_x = tick(st)
                xs.append(st.x0)
                ps.append(st.obst.pos)
                preds.append(pred_x)
            else:
                st = tick(st)
        if collect:
            return st, (torch.stack(xs), torch.stack(ps), torch.stack(preds))
        return st

    return rollout
