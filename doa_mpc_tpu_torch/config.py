"""Configuration: the PyTorch counterpart of ``doa_mpc_tpu/config.py``.

- :class:`WorldSpec` — static (shape-determining) world geometry and problem
  sizes; the same frozen dataclass, fields and properties as the JAX package.
- :class:`CostParams` — runtime cost/constraint parameters as a dataclass of
  tensors (``.to(device, dtype)`` moves them as one object).
- :class:`SolverOptions` — static solver knobs, same fields and defaults.

Every function here that creates a tensor takes an explicit ``device``; the
default is ``"cuda"`` and :func:`resolve_device` raises when it is absent.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, raising if it names CUDA and there is none.

    The port never falls back to the CPU on its own: a CUDA run that finds
    no card is an error, not a slower run."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path")
    return dev


@dataclasses.dataclass(frozen=True)
class WorldSpec:
    """Static world geometry + problem sizes (``doa_mpc_tpu.config.WorldSpec``)."""

    x_min: float = -8.0
    x_max: float = 8.0
    y_min: float = -8.0
    y_max: float = 8.0

    r_robot: float = 0.2
    v_max_robot: float = 10.0

    c_max: float = 8.0

    n_obst: int = 5
    r_obst: float = 1.0
    randomness: float = 0.1
    v_max_obst: float = 2.0
    margin: float = 1.2

    tf: float = 2.0
    n_solv: int = 20

    tol: float = 0.15

    qp_iter: int = 50

    nx: int = 5
    nu: int = 2

    @property
    def dt(self) -> float:
        """Control/simulation tick: TF / N."""
        return self.tf / self.n_solv

    @property
    def robot_box(self) -> Tuple[float, float, float, float]:
        return (self.x_min + 2.0, self.x_max - 2.0, self.y_min + 2.0, self.y_max - 2.0)

    @property
    def obst_box(self) -> Tuple[float, float, float, float]:
        lo = (self.y_min + 2.0) + 1.0 + 3.0 * self.r_robot
        hi = -(self.y_min + 2.0)
        return (lo, hi, lo, hi)

    def replace(self, **kw) -> "WorldSpec":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class CostParams:
    """Runtime cost/constraint parameters (``doa_mpc_tpu.config.CostParams``).

    Shapes: ``q_diag``/``qe_diag`` (4,), ``r_diag`` (2,), the rest scalars.
    """

    q_diag: torch.Tensor
    r_diag: torch.Tensor
    qe_diag: torch.Tensor
    lm_reg: torch.Tensor
    slack_scale: torch.Tensor
    slack_offset: torch.Tensor
    x_bound: torch.Tensor
    v_bound: torch.Tensor
    u_bound: torch.Tensor

    def to(self, device=None, dtype=None) -> "CostParams":
        return CostParams(**{f.name: getattr(self, f.name).to(device=device, dtype=dtype)
                             for f in dataclasses.fields(self)})


def default_cost_params(spec: WorldSpec, dtype=torch.float32,
                        device="cuda") -> CostParams:
    """The reference's LINEAR_LS weights (``doa_mpc_tpu/config.py:108-118``)."""
    dev = resolve_device(device)

    def t(v):
        return torch.tensor(v, dtype=dtype, device=dev)

    return CostParams(
        q_diag=t([2.0, 2.0, 2.0, 2.0]),
        r_diag=t([0.15, 0.15]),
        qe_diag=t([5.0, 5.0, 5.0, 5.0]),
        lm_reg=t(2.0),
        slack_scale=t(1e4),
        slack_offset=t(50.0),
        x_bound=t(7.0),
        v_bound=t(spec.v_max_robot),
        u_bound=t(spec.c_max),
    )


@dataclasses.dataclass(frozen=True)
class SolverOptions:
    """Static solver configuration (``doa_mpc_tpu.config.SolverOptions``):
    the same fields and defaults, the 4-stage Gauss-Legendre IRK with 3
    Newton iterations among them."""

    integrator: str = "irk"
    irk_stages: int = 4
    irk_newton_iter: int = 3
    irk_tableau: str = "gauss_legendre"
    qp_iter: int = 50
    cost_scale_dt: bool = True
    lm_scale_dt: bool = True
    slack_scale_dt: bool = True
    compat_pred_bug: bool = False
    ip_tau: float = 0.99
    ip_reg: float = 1e-9
    ip_mu_min: float = 1e-10
    init_guess_when_error: bool = False
    fail_mu_tol: float = 1e-7
    fail_stat_tol: float = 1e-4
    compat_brake_bug: bool = True
    init_guess: str = "current"
