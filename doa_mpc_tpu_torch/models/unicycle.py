"""Unicycle robot model and obstacle-distance constraints
(``doa_mpc_tpu/models/unicycle.py``).

State  s = (x, y, psi, v, omega), control u = (u_a, u_alpha):
    x' = v cos(psi), y' = v sin(psi), psi' = omega, v' = u_a, omega' = u_alpha.
Obstacle constraint per obstacle i:
    h_i(s, p) = (x - p_x_i)^2 + (y - p_y_i)^2 - (R_OBST + R_ROBOT + MARGIN)^2 >= 0.
All functions broadcast over leading batch dimensions.
"""

from __future__ import annotations

import torch


def dynamics(s: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Continuous-time dynamics f(s, u): ``s`` (..., 5), ``u`` (..., 2) -> (..., 5)."""
    v = s[..., 3]
    psi = s[..., 2]
    return torch.stack(
        [v * torch.cos(psi), v * torch.sin(psi), s[..., 4], u[..., 0], u[..., 1]],
        dim=-1)


def safe_dist_sq(spec) -> float:
    """(R_OBST + R_ROBOT + MARGIN)^2."""
    return (spec.r_obst + spec.r_robot + spec.margin) ** 2


def obstacle_h(s: torch.Tensor, p: torch.Tensor, safe_sq) -> torch.Tensor:
    """Constraint values: ``s`` (..., 5), ``p`` (..., M, 2) centers -> (..., M)."""
    d = s[..., None, 0:2] - p
    return torch.sum(d * d, dim=-1) - safe_sq


def obstacle_h_jac(s: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """dh/ds, shape (..., M, 5): 2*((x, y) - p_i) in the first two columns."""
    d = s[..., None, 0:2] - p
    zeros = torch.zeros(d.shape[:-1] + (3,), dtype=d.dtype, device=d.device)
    return torch.cat([2.0 * d, zeros], dim=-1)
