"""Fixed-step integrators (``doa_mpc_tpu/ops/integrators.py``).

Only explicit RK4 is ported so far; the implicit collocation integrator
(``integrator='irk'``) is ROADMAP item 10. Everything broadcasts over
leading batch dimensions.
"""

from __future__ import annotations

from typing import Callable

import torch


def rk4_step(f: Callable, x: torch.Tensor, u: torch.Tensor, dt,
             substeps: int = 1) -> torch.Tensor:
    """Classic RK4 over ``dt`` with ``substeps`` equal sub-intervals."""
    h = dt / substeps
    for _ in range(substeps):
        k1 = f(x, u)
        k2 = f(x + 0.5 * h * k1, u)
        k3 = f(x + 0.5 * h * k2, u)
        k4 = f(x + h * k3, u)
        x = x + (h / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
    return x


def make_integrator(options) -> Callable:
    """Build Phi(x, u, dt) from :class:`doa_mpc_tpu_torch.config.SolverOptions`."""
    from doa_mpc_tpu_torch.models.unicycle import dynamics

    if options.integrator == "rk4":
        def step(x, u, dt):
            return rk4_step(dynamics, x, u, dt)
        return step
    if options.integrator == "irk":
        raise NotImplementedError(
            "integrator='irk' is not ported yet (ROADMAP item 10); "
            "pass SolverOptions(integrator='rk4')")
    raise ValueError(f"unknown integrator {options.integrator!r}")
