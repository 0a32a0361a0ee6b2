"""OCP-structured QP data container (``doa_mpc_tpu/ops/ocp_qp.py``).

The per-tick QP in the delta variables around the linearization point:

    min   sum_k 1/2 dz_k' H_k dz_k + g_k' dz_k + 1/2 dx_N' Q_N dx_N + q_N' dx_N
          + sum_{k,i} zl[k,i] s[k,i] + 1/2 Zl[k,i] s[k,i]^2
    s.t.  dx_{k+1} = A_k dx_k + B_k du_k + c_k,   dx_0 = dx0
          lb_u <= du_k <= ub_u,   lb_x <= E dx_k <= ub_x  (E selects IDXBX)
          hval[k] + C_k dx_k + s_k >= 0,  s_k >= 0

Fields are batch-first: a leading scenario axis B on every field.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

BIG_BOUND = 1e6

IDXBX = (0, 1, 3, 4)


# The two helpers below index IDXBX by Python ints, one column at a time: an
# index list would be copied to the device on every call, and the host would
# wait for the copy.

def gather_idxbx(v: torch.Tensor) -> torch.Tensor:
    """E v: the IDXBX entries of (..., nx) -> (..., nbx)."""
    return torch.stack([v[..., i] for i in IDXBX], -1)


def scatter_idxbx(vals: torch.Tensor, nx: int) -> torch.Tensor:
    """E' v: (..., nbx) values on the IDXBX selection -> (..., nx), zeros
    elsewhere."""
    cols = [torch.zeros_like(vals[..., 0])] * nx
    for j, i in enumerate(IDXBX):
        cols[i] = vals[..., j]
    return torch.stack(cols, -1)


class OcpQp(NamedTuple):
    """QP data, batch-first (B = scenarios, N = horizon, M = soft rows):

    dynamics:  A (B, N, nx, nx), B (B, N, nx, nu), c (B, N, nx), dx0 (B, nx)
    cost:      Q (B, N+1, nx, nx), q (B, N+1, nx), R (B, N, nu, nu),
               r (B, N, nu), S (B, N, nu, nx)
    u box:     lb_u, ub_u (B, N, nu)
    x box:     lb_x, ub_x (B, N+1, nbx) on the IDXBX selection
    soft:      C (B, N+1, M, nx), hval (B, N+1, M), zl, Zl (B, N+1, M)
    """

    A: torch.Tensor
    B: torch.Tensor
    c: torch.Tensor
    dx0: torch.Tensor
    Q: torch.Tensor
    q: torch.Tensor
    R: torch.Tensor
    r: torch.Tensor
    S: torch.Tensor
    lb_u: torch.Tensor
    ub_u: torch.Tensor
    lb_x: torch.Tensor
    ub_x: torch.Tensor
    C: torch.Tensor
    hval: torch.Tensor
    zl: torch.Tensor
    Zl: torch.Tensor


def normalize_cost(qp: OcpQp) -> tuple[OcpQp, torch.Tensor]:
    """Scale each scenario's objective by 1/kappa so its largest coefficient
    is O(1): kappa = max(|diag Q|, |diag R|, zl, Zl, 1). The primal minimizer
    is unchanged. Returns the scaled QP and kappa (B,)."""

    def rmax(a):
        return torch.amax(a.flatten(1), dim=1)

    def bc(s, a):
        return s.reshape(s.shape + (1,) * (a.ndim - 1))

    ones = torch.ones(qp.A.shape[:1], dtype=qp.Q.dtype, device=qp.Q.device)
    kappa = torch.maximum(
        torch.maximum(rmax(torch.abs(torch.diagonal(qp.Q, dim1=-2, dim2=-1))),
                      rmax(torch.abs(torch.diagonal(qp.R, dim1=-2, dim2=-1)))),
        torch.maximum(torch.maximum(rmax(qp.zl), rmax(qp.Zl)), ones))
    inv = 1.0 / kappa
    return qp._replace(
        Q=qp.Q * bc(inv, qp.Q), q=qp.q * bc(inv, qp.q),
        R=qp.R * bc(inv, qp.R), r=qp.r * bc(inv, qp.r),
        S=qp.S * bc(inv, qp.S),
        zl=qp.zl * bc(inv, qp.zl), Zl=qp.Zl * bc(inv, qp.Zl),
    ), kappa
