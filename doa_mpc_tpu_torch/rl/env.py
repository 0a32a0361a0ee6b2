"""Batched subgoal environment: MPC rollouts as the RL transition kernel
(``doa_mpc_tpu/rl/env.py``).

The agent proposes one (x, y) subgoal per scenario, the RTI MPC controller
runs ``k_ticks`` control ticks toward it, and the agent is rewarded for safe
progress toward the final goal. B scenarios advance in lockstep through the
parametric tick (``sim/closed_loop.make_parametric_tick``, its solves in
kernel K2 on the card). Observations are the normalized robot pose plus
each obstacle's position and clearance: 3 * (n_obst + 1) numbers.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from doa_mpc_tpu_torch.config import (
    CostParams, SolverOptions, WorldSpec, default_cost_params, resolve_device,
)
from doa_mpc_tpu_torch.sim.closed_loop import LoopState, init_loop_state, make_parametric_tick
from doa_mpc_tpu_torch.sim.obstacles import robot_start_goal
from doa_mpc_tpu_torch.solver.sqp_rti import make_rti_controller


class EnvState(NamedTuple):
    loop: LoopState          # batched closed-loop state
    goal: torch.Tensor       # (B, 2) final goals
    prev_dist: torch.Tensor  # (B,) distance to the final goal at the last step
    t: torch.Tensor          # (B,) int32 env steps taken
    done: torch.Tensor       # (B,) bool episode finished


class SubgoalEnv:
    """Batched MPC subgoal environment.

    Rewards (the JAX package's design):
      progress        + (prev_dist - dist)
      goal reached    + 100
      collision       - 100, the episode ends
      per step        - 0.5

    The world comes from the generator given to :meth:`reset`, and so does
    the obstacle noise of the episode's ticks. ``steps_taken`` counts the
    calls of :meth:`step`."""

    def __init__(self, spec: WorldSpec | None = None,
                 opts: SolverOptions | None = None,
                 params: CostParams | None = None,
                 batch: int = 64, k_ticks: int = 10, max_steps: int = 40,
                 scenario: str = "RANDOM", dtype=torch.float32, device="cuda"):
        self.spec = spec or WorldSpec(tf=2.0, n_solv=20, qp_iter=10)
        self.opts = opts or SolverOptions(qp_iter=10, integrator="rk4")
        self.scenario = scenario
        self.device = resolve_device(device)
        self.ctrl = make_rti_controller(self.spec, self.opts, dtype=dtype, device=self.device)
        self.params = params or default_cost_params(self.spec, dtype=dtype, device=self.device)
        self.batch = batch
        self.k_ticks = k_ticks
        self.max_steps = max_steps
        self.dtype = dtype
        self.obs_dim = 3 * (self.spec.n_obst + 1)
        self.act_dim = 2
        self._tick = make_parametric_tick(self.ctrl)
        self._generator = None
        self.steps_taken = 0

    # -- observation ----------------------------------------------------
    def _obs(self, st: EnvState) -> torch.Tensor:
        sc = 1.0 / self.spec.x_max
        x0 = st.loop.x0
        robot = torch.stack([x0[..., 0] * sc, x0[..., 1] * sc, x0[..., 2] / torch.pi], -1)
        rel = st.loop.obst.pos - x0[..., None, :2]
        clearance = torch.linalg.norm(rel, dim=-1) - (self.spec.r_obst + self.spec.r_robot)
        per_obst = torch.cat([st.loop.obst.pos * sc, clearance[..., None] * sc], -1)  # (B,M,3)
        return torch.cat([robot, per_obst.reshape(per_obst.shape[:-2] + (-1,))], -1)

    # -- reset ----------------------------------------------------------
    def reset(self, generator: torch.Generator | None,
              scenario: str | None = None) -> Tuple[EnvState, torch.Tensor]:
        """Fresh worlds drawn from ``generator`` (on the env's device), which
        then also draws the obstacle noise of every following step."""
        scenario = self.scenario if scenario is None else scenario
        self._generator = generator
        start, goal = robot_start_goal(self.spec)
        loop = init_loop_state(self.ctrl, start, goal, scenario, batch_shape=(self.batch,),
                               generator=generator)
        goals = torch.as_tensor(goal, dtype=self.dtype, device=self.device)
        goals = goals.expand(self.batch, 2).clone()
        dist0 = torch.linalg.norm(loop.x0[:, :2] - goals, dim=-1)
        st = EnvState(loop=loop, goal=goals, prev_dist=dist0,
                      t=torch.zeros((self.batch,), dtype=torch.int32, device=self.device),
                      done=torch.zeros((self.batch,), dtype=torch.bool, device=self.device))
        return st, self._obs(st)

    # -- step -----------------------------------------------------------
    def step(self, st: EnvState, actions: torch.Tensor):
        """Run ``k_ticks`` MPC ticks toward the per-row subgoals ``actions``
        (B, 2).

        The loop's own done flag refers to the subgoal, the episode's to the
        final goal, so the loop's flag is cleared before each step (a
        subgoal reached mid-step parks the robot there). Rows that are done
        stay frozen and earn 0. Returns (state, obs, reward, done)."""
        self.steps_taken += 1
        loop = st.loop._replace(done=torch.zeros_like(st.loop.done))
        hit_before = loop.min_margin <= 0.0
        for _ in range(self.k_ticks):
            noise = torch.randn(loop.obst.vel.shape, generator=self._generator,
                                dtype=loop.obst.vel.dtype, device=loop.obst.vel.device)
            loop = self._tick(loop, actions, self.params, noise=noise)

        dist = torch.linalg.norm(loop.x0[:, :2] - st.goal, dim=-1)
        reached = dist <= self.spec.tol
        hit_now = (loop.min_margin <= 0.0) & ~hit_before
        t = st.t + 1
        done = st.done | reached | hit_now | (t >= self.max_steps)

        reward = ((st.prev_dist - dist)
                  + 100.0 * reached.to(dist.dtype)
                  - 100.0 * hit_now.to(dist.dtype)
                  - 0.5)
        reward = torch.where(st.done, torch.zeros_like(reward), reward)

        def keep(old, upd):      # frozen rows keep their old state
            return torch.where(st.done.reshape(st.done.shape + (1,) * (upd.ndim - 1)),
                               old, upd)

        new = EnvState(
            loop=LoopState(*(type(o)(*map(keep, o, u)) if isinstance(o, tuple) else keep(o, u)
                             for o, u in zip(st.loop, loop))),
            goal=st.goal, prev_dist=keep(st.prev_dist, dist), t=keep(st.t, t),
            done=keep(st.done, done))
        return new, self._obs(new), reward, new.done
