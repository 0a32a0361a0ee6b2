"""Bit-exact reproduction of the reference's MT19937 random streams
(copy of ``doa_mpc_tpu/sim/compat_rng.py``).

The reference seeds numpy's global legacy RandomState once per experiment
(``np.random.seed(i)``) and then draws, in this exact order:

1. obstacle placement — ``uniform(X_MIN_OBST, X_MAX_OBST, (M, 1))`` for x,
   then y, then ``uniform(-V_MAX_OBST, V_MAX_OBST, (M, 1))`` for vx, then vy
   (CENTER/EDGE skip the two position draws);
2. per executed control tick, for each obstacle in list order,
   ``np.random.normal(size=2)`` velocity noise.

This module regenerates those streams with ``np.random.RandomState(seed)``.
It is numpy only; it imports the port's ``ObstacleState`` (a NamedTuple) so
that nothing of JAX is loaded.
"""

from __future__ import annotations

import numpy as np

from doa_mpc_tpu_torch.sim.obstacles import ObstacleState


def mt_experiment_streams(seed: int, spec, scenario: str = "RANDOM",
                          max_iter: int = 400, dtype=np.float32):
    """MT19937 streams for one seeded experiment: ``(obst, noise)`` with
    ``obst`` the initial world ((M, 2) numpy pos / vel) and ``noise`` the
    ``(max_iter, M, 2)`` standard-normal velocity-noise stream."""
    rs = np.random.RandomState(seed)
    m = spec.n_obst
    xlo, xhi, ylo, yhi = spec.obst_box
    if scenario == "RANDOM":
        x = rs.uniform(xlo, xhi, (m, 1))
        y = rs.uniform(ylo, yhi, (m, 1))
    elif scenario == "CENTER":
        x = np.zeros((m, 1))
        y = np.zeros((m, 1))
    elif scenario == "EDGE":
        x = 7.0 * np.ones((m, 1))
        y = 7.0 * np.ones((m, 1))
    else:
        raise ValueError(f"unknown scenario {scenario!r}")
    v = spec.v_max_obst
    vx = rs.uniform(-v, v, (m, 1))
    vy = rs.uniform(-v, v, (m, 1))
    pos = np.hstack([x, y]).astype(dtype)
    vel = np.hstack([vx, vy]).astype(dtype)
    noise = rs.normal(size=(max_iter, m, 2)).astype(dtype)
    return ObstacleState(pos=pos, vel=vel), noise


def mt_experiment_batch(seeds, spec, scenario: str = "RANDOM",
                        max_iter: int = 400, dtype=np.float32):
    """Streams for a batch of seeds: ``obst`` pos/vel (B, M, 2) and ``noise``
    (max_iter, B, M, 2), tick-major as the batched rollout consumes it."""
    obsts, noises = zip(*(mt_experiment_streams(int(s), spec, scenario,
                                                max_iter, dtype)
                          for s in seeds))
    pos = np.stack([o.pos for o in obsts])
    vel = np.stack([o.vel for o in obsts])
    noise = np.stack(noises, axis=1)
    return ObstacleState(pos=pos, vel=vel), noise
