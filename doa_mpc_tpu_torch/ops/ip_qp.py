"""Interior-point solution container (``doa_mpc_tpu/ops/ip_qp.py``).

Only :class:`IpSolution` is ported so far. The XLA-style solver and the
Riccati module it uses are ROADMAP item 4; the main path solves through
``ops/ip_fused.py``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class IpSolution(NamedTuple):
    dx: torch.Tensor        # (B, N+1, nx)
    du: torch.Tensor        # (B, N, nu)
    s: torch.Tensor         # (B, N+1, M) soft slacks
    mu: torch.Tensor        # (B,) duality measure of the last iteration
    kappa: torch.Tensor     # (B,) objective normalization used internally
    stat_res: torch.Tensor  # (B,) stationarity residual (normalized)
