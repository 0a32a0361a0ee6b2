"""Fixed-step integrators (``doa_mpc_tpu/ops/integrators.py``).

- :func:`rk4_step`: classic explicit RK4.
- :func:`irk_step`: implicit Runge-Kutta collocation (Gauss-Legendre of any
  stage count, Radau IIA up to 3 stages; the tableaus are built in numpy on
  the host) with a fixed number of full-Newton iterations on the stacked
  stage derivatives, as acados' IRK with a fixed ``newton_iter``.

Everything broadcasts over leading batch dimensions. The IRK sensitivities
come from the implicit-function theorem at the converged stage states, not
from differentiating through the Newton iterations, and ``torch.func``
reads them through :class:`_IrkSubstep`'s ``jvp``.
"""

from __future__ import annotations

import functools
from typing import Callable, Tuple

import numpy as np
import torch
from torch.func import jacfwd, vmap


# ---------------------------------------------------------------------------
# Butcher tableau construction (host side)
# ---------------------------------------------------------------------------

def _collocation_tableau(c: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(A, b) of the collocation method with nodes ``c`` in (0, 1]:
    A_ij = integral_0^{c_i} l_j(t) dt, b_j = integral_0^1 l_j(t) dt over the
    Lagrange basis polynomials l_j on the nodes (Hairer & Wanner, Solving
    ODEs II, Thm IV.5.2)."""
    s = len(c)
    A = np.zeros((s, s))
    b = np.zeros(s)
    for j in range(s):
        poly = np.poly1d([1.0])
        for k in range(s):
            if k != j:
                poly *= np.poly1d([1.0, -c[k]]) / (c[j] - c[k])
        integ = poly.integ()
        b[j] = integ(1.0) - integ(0.0)
        for i in range(s):
            A[i, j] = integ(c[i]) - integ(0.0)
    return A, b


# Radau IIA nodes (right endpoint included); s=3 is acados' GAUSS_RADAU_IIA
# with num_stages=3
_RADAU_IIA_NODES = {
    1: np.array([1.0]),
    2: np.array([1.0 / 3.0, 1.0]),
    3: np.array([(4.0 - np.sqrt(6.0)) / 10.0, (4.0 + np.sqrt(6.0)) / 10.0, 1.0]),
}


@functools.lru_cache(maxsize=None)
def butcher_tableau(kind: str, stages: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Return (A, b, c) for the requested implicit collocation scheme."""
    if kind == "gauss_legendre":
        x, _ = np.polynomial.legendre.leggauss(stages)
        c = (x + 1.0) / 2.0
    elif kind == "radau_iia":
        if stages not in _RADAU_IIA_NODES:
            raise ValueError(f"radau_iia supported for stages<=3, got {stages}")
        c = _RADAU_IIA_NODES[stages]
    else:
        raise ValueError(f"unknown tableau kind {kind!r}")
    A, b = _collocation_tableau(np.asarray(c, dtype=np.float64))
    return A, b, np.asarray(c, dtype=np.float64)


@functools.lru_cache(maxsize=None)
def _tableau_tensors(kind: str, stages: int, dtype: torch.dtype, device: torch.device):
    """(A, b) of :func:`butcher_tableau` as tensors, copied to each device once."""
    A, b, _ = butcher_tableau(kind, stages)
    return (torch.tensor(A, dtype=dtype, device=device),
            torch.tensor(b, dtype=dtype, device=device))


# ---------------------------------------------------------------------------
# Explicit RK4
# ---------------------------------------------------------------------------

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


# ---------------------------------------------------------------------------
# Implicit RK (collocation + fixed Newton)
# ---------------------------------------------------------------------------

def _stage_jacobians(f: Callable, Z: torch.Tensor, u: torch.Tensor, argnums):
    """Jacobians of f at each stage state, Z (..., s, nx), u (..., nu): one
    (..., s, nx, n_arg) tensor per entry of ``argnums``."""
    nx, nu = Z.shape[-1], u.shape[-1]
    u_b = u.unsqueeze(-2).expand(Z.shape[:-1] + (nu,))
    jac = vmap(jacfwd(f, argnums=argnums))(Z.reshape(-1, nx), u_b.reshape(-1, nu))
    return [J.reshape(Z.shape + J.shape[-1:]) for J in jac]


def _newton_lu(A: torch.Tensor, Jf: torch.Tensor, h):
    """LU factors of the collocation Newton matrix M (..., s nx, s nx), whose
    block (i, j) is delta_ij I - h A_ij Jf_i: the Jacobian of the residual
    R_i = K_i - f(Z_i) in K_j."""
    s, nx = Jf.shape[-3], Jf.shape[-1]
    blocks = -h * A[:, :, None, None] * Jf.unsqueeze(-3)        # (..., s, s, nx, nx)
    M = blocks.transpose(-3, -2).reshape(Jf.shape[:-3] + (s * nx, s * nx))
    M = M + torch.eye(s * nx, dtype=M.dtype, device=M.device)
    # the _ex form: lu_factor would wait for the card to check ``info``
    LU, piv, _ = torch.linalg.lu_factor_ex(M)
    return LU, piv


def _stage_states(x, K, A, h):
    """Z_i = x + h sum_j A_ij K_j, K (..., s, nx)."""
    return x.unsqueeze(-2) + h * torch.einsum("ij,...jn->...in", A, K)


class _IrkSubstep(torch.autograd.Function):
    """One collocation substep Phi(x, u) with its IFT sensitivities.

    ``forward`` runs the fixed Newton iterations, then rebuilds M at the
    converged stage states Z (K recomputed, Jf, Ju), factors it once and
    solves M dK = [Jf | Ju] for all nx + nu directions at once. It returns
    Phi and D = dPhi/d(x, u) = [I | 0] + h sum_j b_j dK_j (..., nx, nx + nu);
    ``jvp`` reads D back from ``ctx.save_for_forward``. So under
    ``vmap(jacfwd(...))`` M is factored once per stage point, whatever the
    number of tangent directions. (The solve is not left to ``jvp``: under
    nested ``vmap``, ``torch.linalg.lu_solve``'s batching rule returns
    wrong values when the factors are batched at the outer level only.)
    """

    generate_vmap_rule = True

    @staticmethod
    def forward(x, u, f, h, A, b, newton_iter):
        s, nx = A.shape[0], x.shape[-1]
        u_stage = u.unsqueeze(-2)
        f0 = f(x, u)
        K = f0.unsqueeze(-2).expand(f0.shape[:-1] + (s, nx))
        for _ in range(newton_iter):
            Z = _stage_states(x, K, A, h)
            R = K - f(Z, u_stage.expand(Z.shape[:-1] + u.shape[-1:]))
            (Jf,) = _stage_jacobians(f, Z, u, (0,))
            LU, piv = _newton_lu(A, Jf, h)
            dK = torch.linalg.lu_solve(LU, piv, R.reshape(R.shape[:-2] + (s * nx, 1)))
            K = K - dK.reshape(K.shape)
        Z = _stage_states(x, K, A, h)
        Jf, Ju = _stage_jacobians(f, Z, u, (0, 1))
        LU, piv = _newton_lu(A, Jf, h)
        J = torch.cat([Jf, Ju], dim=-1)                        # (..., s, nx, nx + nu)
        dK = torch.linalg.lu_solve(LU, piv, J.reshape(J.shape[:-3] + (s * nx, J.shape[-1])))
        dK = dK.reshape(J.shape)
        eye = torch.eye(nx, J.shape[-1], dtype=x.dtype, device=x.device)
        D = eye + h * torch.einsum("j,...jnm->...nm", b, dK)
        phi = x + h * torch.einsum("j,...jn->...n", b, K)
        return phi, D

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, D = output
        ctx.mark_non_differentiable(D)
        ctx.save_for_forward(D)

    @staticmethod
    def jvp(ctx, dx, du, *_):
        (D,) = ctx.saved_tensors
        nx = D.shape[-2]
        dphi = torch.einsum("...ij,...j->...i", D[..., :nx], dx)
        if du is not None:
            dphi = dphi + torch.einsum("...ij,...j->...i", D[..., nx:], du)
        return dphi, None


def irk_step(f: Callable, x: torch.Tensor, u: torch.Tensor, dt, *,
             stages: int = 4, newton_iter: int = 3,
             tableau: str = "gauss_legendre", num_steps: int = 1) -> torch.Tensor:
    """One implicit-RK step of size ``dt``, optionally split into
    ``num_steps`` substeps.

    Solves K_i = f(x + h sum_j A_ij K_j, u) with exactly ``newton_iter``
    full-Newton iterations on K (..., s, nx), starting from K_i = f(x, u);
    each iteration rebuilds the Jacobian of f at the current stage states
    and solves the (s nx x s nx) Newton system with a pivoted LU
    (``torch.linalg.lu_factor_ex``/``lu_solve``). Differentiating the result
    with ``torch.func`` gives the IFT sensitivities of :class:`_IrkSubstep`.
    """
    A, b = _tableau_tensors(tableau, stages, x.dtype, x.device)
    h = dt / num_steps
    for _ in range(num_steps):
        x, _ = _IrkSubstep.apply(x, u, f, h, A, b, newton_iter)
    return x


def make_integrator(options) -> Callable:
    """Build Phi(x, u, dt) from :class:`doa_mpc_tpu_torch.config.SolverOptions`."""
    from doa_mpc_tpu_torch.models.unicycle import dynamics

    if options.integrator == "rk4":
        def step(x, u, dt):
            return rk4_step(dynamics, x, u, dt)
    elif options.integrator == "irk":
        def step(x, u, dt):
            return irk_step(dynamics, x, u, dt, stages=options.irk_stages,
                            newton_iter=options.irk_newton_iter,
                            tableau=options.irk_tableau)
    else:
        raise ValueError(f"unknown integrator {options.integrator!r}")
    return step
