"""Vectorized obstacle world (``doa_mpc_tpu/sim/obstacles.py``).

The world is one tensor pair ``pos``/``vel`` of shape (..., M, 2), advanced
for the whole batch at once:

- wall bounce per axis: an obstacle whose time-to-wall is within ``dt``
  travels to the wall and reflects for the remaining time;
- motion noise: velocities scale by ``(1 + randomness * N(0, 1))`` and clamp
  to +-v_max_obst before the bounce;
- the forecast is the noise-free bounce, evaluated in closed form as the
  triangle-wave fold of the free path into the box (``compat_pred_bug``
  reproduces the reference's ``vx = vy`` typo);
- scenarios RANDOM / CENTER / EDGE place obstacles as the reference does.

Random draws come from an explicit ``torch.Generator``; they cannot match
``jax.random``, so cross-package comparisons feed ``sim/compat_rng`` worlds
and noise to both.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from doa_mpc_tpu_torch.config import resolve_device

SCENARIOS = ("RANDOM", "CENTER", "EDGE")


class ObstacleState(NamedTuple):
    """World state: positions (..., M, 2) and velocities (..., M, 2)."""

    pos: torch.Tensor
    vel: torch.Tensor


def generate_obstacles(generator: torch.Generator, spec, scenario: str,
                       batch_shape=(), dtype=torch.float32,
                       device="cuda") -> ObstacleState:
    """Sample an obstacle world: positions uniform in the obstacle box
    (RANDOM), at the origin (CENTER) or at (7, 7) (EDGE); velocities uniform
    in +-v_max_obst. ``generator`` must live on ``device``."""
    dev = resolve_device(device)
    shape = tuple(batch_shape) + (spec.n_obst,)
    lo, hi, _, _ = spec.obst_box

    def uniform(a, b):
        u = torch.rand(shape, generator=generator, dtype=dtype, device=dev)
        return a + (b - a) * u

    if scenario == "RANDOM":
        x = uniform(lo, hi)
        y = uniform(lo, hi)
    elif scenario == "CENTER":
        x = torch.zeros(shape, dtype=dtype, device=dev)
        y = torch.zeros(shape, dtype=dtype, device=dev)
    elif scenario == "EDGE":
        x = torch.full(shape, 7.0, dtype=dtype, device=dev)
        y = torch.full(shape, 7.0, dtype=dtype, device=dev)
    else:
        raise ValueError(f"unknown scenario {scenario!r}")
    v = spec.v_max_obst
    vx = uniform(-v, v)
    vy = uniform(-v, v)
    return ObstacleState(pos=torch.stack([x, y], -1), vel=torch.stack([vx, vy], -1))


def _bounce_axis(p, v, dt, lo, hi):
    """One axis of the exact wall-reflection step."""
    avs = torch.clamp_min(torch.abs(v), 1e-30)
    inf = torch.full_like(p, float("inf"))
    t_hit = torch.where(v < 0, (p - lo) / avs,
                        torch.where(v > 0, (hi - p) / avs, inf))
    hit = t_hit <= dt
    p_new = torch.where(hit, p + v * t_hit - v * (dt - t_hit), p + v * dt)
    v_new = torch.where(hit, -v, v)
    return p_new, v_new


def bounce_step(state: ObstacleState, spec, dt=None) -> ObstacleState:
    """Noise-free constant-velocity step with wall reflection."""
    dt = spec.dt if dt is None else dt
    px, vx = _bounce_axis(state.pos[..., 0], state.vel[..., 0], dt, spec.x_min, spec.x_max)
    py, vy = _bounce_axis(state.pos[..., 1], state.vel[..., 1], dt, spec.y_min, spec.y_max)
    return ObstacleState(torch.stack([px, py], -1), torch.stack([vx, vy], -1))


def obstacle_step(state: ObstacleState, spec, random_move: bool = True,
                  noise: torch.Tensor | None = None,
                  generator: torch.Generator | None = None) -> ObstacleState:
    """Simulation step: velocity noise (with ``random_move``), then bounce.

    ``noise`` is a standard-normal draw shaped like ``vel`` (the compat
    stream); without it the draw comes from ``generator``. Without
    ``random_move`` the step is a plain :func:`bounce_step` and draws
    nothing."""
    if random_move:
        if noise is None:
            noise = torch.randn(state.vel.shape, generator=generator,
                                dtype=state.vel.dtype, device=state.vel.device)
        vel = (1.0 + spec.randomness * noise) * state.vel
        vel = torch.clamp(vel, -spec.v_max_obst, spec.v_max_obst)
        state = ObstacleState(state.pos, vel)
    return bounce_step(state, spec)


@functools.lru_cache(maxsize=None)
def _box(x_min, y_min, x_max, y_max, dtype, device):
    """The box's corners (x_min, y_min) and (x_max, y_max) as tensors, copied
    to each device once: a copy per call would make the host wait for it."""
    return (torch.tensor([x_min, y_min], dtype=dtype, device=device),
            torch.tensor([x_max, y_max], dtype=dtype, device=device))


def predict_trajectory(state: ObstacleState, spec, n: int,
                       compat_pred_bug: bool = False) -> torch.Tensor:
    """Noise-free n-step position forecast -> (n+1, ..., M, 2).

    Closed form: the specular bounce sampled at k*dt is the triangle-wave
    fold of ``p0 + v*t`` into the box. ``torch.remainder`` takes the sign of
    the divisor like ``jnp.mod`` (``torch.fmod`` would be wrong for negative
    free paths)."""
    if compat_pred_bug:
        vel = torch.stack([state.vel[..., 1], state.vel[..., 1]], -1)
        state = ObstacleState(state.pos, vel)

    pos = state.pos
    t = (torch.arange(n + 1, dtype=pos.dtype, device=pos.device) * spec.dt).reshape(
        (n + 1,) + (1,) * pos.ndim)
    lo, hi = _box(spec.x_min, spec.y_min, spec.x_max, spec.y_max, pos.dtype, pos.device)
    period = 2.0 * (hi - lo)
    free = (pos - lo)[None] + t * state.vel[None]
    y = torch.remainder(free, period)
    return lo + torch.minimum(y, period - y)


def _predict_trajectory_scan(state: ObstacleState, spec, n: int) -> torch.Tensor:
    """The forecast as n explicit bounce steps: the oracle for the fold."""
    out = [state.pos]
    for _ in range(n):
        state = bounce_step(state, spec)
        out.append(state.pos)
    return torch.stack(out, 0)


def robot_start_goal(spec, margin: float = 1.0):
    """Canonical start (X_MIN+margin, Y_MIN+margin, pi/4, 0, 0) and goal
    (X_MAX-margin, Y_MAX-margin), as numpy arrays."""
    start = np.array([spec.x_min + margin, spec.y_min + margin, np.pi / 4, 0.0, 0.0])
    goal = np.array([spec.x_max - margin, spec.y_max - margin])
    return start, goal
