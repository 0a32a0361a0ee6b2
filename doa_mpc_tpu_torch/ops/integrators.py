"""Fixed-step integrators (``doa_mpc_tpu/ops/integrators.py``).

- :func:`rk4_step`: classic explicit RK4.
- :func:`irk_step`: implicit Runge-Kutta collocation (Gauss-Legendre of any
  stage count, Radau IIA up to 3 stages; the tableaus are built in numpy on
  the host) with a fixed number of full-Newton iterations on the stacked
  stage derivatives, as acados' IRK with a fixed ``newton_iter``.

Everything broadcasts over leading batch dimensions. On CPU tensors the IRK
step is the plain version: the JAX package's functions line for line
(:func:`_irk_substep`, whose Newton system is solved by the block LU without
pivoting, :func:`irk_newton_solve_ref`, and whose Jacobians come from
``torch.func.jacfwd``). On CUDA tensors, for the unicycle's dynamics, the
whole step (every substep, Newton iteration and the sensitivities) is one
launch of kernel K3 (``csrc/irk_step.cu``, :func:`irk_step_fused`). The IRK
sensitivities come from the implicit-function theorem at the converged
stage states, not from differentiating through the Newton iterations:
``irk_step(..., sensitivities=True)`` returns them, and
:func:`make_linearization` reads the controller's (Phi, A, B) from them,
where rk4 is differentiated by ``torch.func.jacfwd``.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Callable, NamedTuple, Tuple

import numpy as np
import torch
from torch.func import jacfwd, vmap

from doa_mpc_tpu_torch.ops import cuda_build
from doa_mpc_tpu_torch.utils.profiling import span


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
# The collocation Newton solve: block LU without pivoting (the plain
# version of kernel K3's factorization and solves)
# ---------------------------------------------------------------------------

def _inv_small(D: torch.Tensor) -> torch.Tensor:
    """Unrolled no-pivot Gauss-Jordan inverse of (..., n, n), n small."""
    n = D.shape[-1]
    eye = torch.eye(n, dtype=D.dtype, device=D.device).expand(D.shape)
    aug = torch.cat([D, eye], dim=-1)
    for k in range(n):
        row = aug[..., k, :] / aug[..., k, k:k + 1]
        aug[..., k, :] = row
        col = aug[..., :, k].clone()
        col[..., k] = 0.0
        aug = aug - col[..., :, None] * row[..., None, :]
    return aug[..., n:]


def _newton_blocks(A: torch.Tensor, Jf: torch.Tensor, h) -> torch.Tensor:
    """Blocks of the collocation Newton matrix: (..., s, s, nx, nx) with
    M[i, j] = delta_ij I - h A_ij Jf_i (Jacobian of R_i = K_i - f(Z_i))."""
    s, nx = Jf.shape[-3], Jf.shape[-1]
    M = -h * A[:, :, None, None] * Jf[..., :, None, :, :]
    eye = torch.eye(nx, dtype=Jf.dtype, device=Jf.device)
    for k in range(s):
        M[..., k, k, :, :] += eye
    return M


def _block_lu(M: torch.Tensor):
    """Block LU without pivoting of (..., s, s, nx, nx).

    Returns the packed factors (L with identity diagonal blocks strictly
    below, the Schur-complement U on/above) plus the list of inverted
    diagonal blocks (reused by every subsequent solve). Safe without
    pivoting because M = I - h (A (x) Jf) with ||h A Jf|| << 1. The JAX
    function updates a functional copy; this one updates a copy of ``M`` in
    place.
    """
    s = M.shape[-4]
    M = M.clone()
    invd = []
    for k in range(s):
        ik = _inv_small(M[..., k, k, :, :])
        invd.append(ik)
        for i in range(k + 1, s):
            Lik = M[..., i, k, :, :] @ ik
            M[..., i, k, :, :] = Lik
            for j in range(k + 1, s):
                M[..., i, j, :, :] += -Lik @ M[..., k, j, :, :]
    return M, invd


def _block_solve(LU: torch.Tensor, invd, r: torch.Tensor) -> torch.Tensor:
    """Solve the block-factored system for r of shape (..., s, nx)."""
    s = LU.shape[-4]
    y = []
    for i in range(s):                       # forward, unit-block-lower
        acc = r[..., i, :]
        for j in range(i):
            acc = acc - torch.einsum("...ab,...b->...a", LU[..., i, j, :, :], y[j])
        y.append(acc)
    xs = [None] * s
    for k in reversed(range(s)):             # backward, block-upper
        acc = y[k]
        for j in range(k + 1, s):
            acc = acc - torch.einsum("...ab,...b->...a", LU[..., k, j, :, :], xs[j])
        xs[k] = torch.einsum("...ab,...b->...a", invd[k], acc)
    return torch.stack(xs, dim=-2)


def irk_newton_solve_ref(Jf: torch.Tensor, A: torch.Tensor, h, rhs: torch.Tensor) -> torch.Tensor:
    """The blocks of M = I - h (A (x) Jf), their block LU and the
    block-triangular solve M X = rhs, with JAX's functions' order of
    operations (what kernel K3 computes in each Newton iteration). Jf (R, s, nx, nx), rhs (R, s, nx, k) -> (R, s, nx, k);
    each of the k columns is solved as JAX solves one vector."""
    LU, invd = _block_lu(_newton_blocks(A, Jf, h))
    cols = rhs.movedim(-1, 1)                                  # (R, k, s, nx)
    X = _block_solve(LU.unsqueeze(1), [ik.unsqueeze(1) for ik in invd], cols)
    return X.movedim(1, -1)


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


def _ordered_sum(P: torch.Tensor, dim: int) -> torch.Tensor:
    """The sum of P over the stage axis ``dim``, added in the order 0, 1, ...
    element by element: no matrix product, whose kernel (and summation
    order) the library would pick by size, so a row's bits do not depend on
    the batch."""
    acc = P.select(dim, 0)
    for j in range(1, P.shape[dim]):
        acc = acc + P.select(dim, j)
    return acc


def _stage_states(x, K, A, h):
    """Z_i = x + h sum_j A_ij K_j, K (..., s, nx)."""
    return x.unsqueeze(-2) + h * _ordered_sum(A[:, :, None] * K.unsqueeze(-3), -2)


def _irk_substep(f, x, u, h, A, b, newton_iter, sensitivities):
    """One collocation substep over rows, x (R, nx), u (R, nu): Phi, and with
    ``sensitivities`` also D = dPhi/d(x, u) (R, nx, nx + nu); the plain
    version of one substep of kernel K3.

    The fixed Newton iterations solve the collocation system through
    :func:`irk_newton_solve_ref`, starting from K_i = f(x, u). D comes from
    the implicit-function theorem at the converged stage states, as the JAX
    package's ``custom_jvp`` rule gives it: M (rebuilt there) dK = [Jf | Ju]
    solved for all nx + nu directions in one call, D = [I | 0] + h sum_j
    b_j dK_j."""
    s, nx = A.shape[0], x.shape[-1]
    u_stage = u.unsqueeze(-2).expand(u.shape[:-1] + (s, u.shape[-1]))
    f0 = f(x, u)
    K = f0.unsqueeze(-2).expand(f0.shape[:-1] + (s, nx))
    for _ in range(newton_iter):
        Z = _stage_states(x, K, A, h)
        R = K - f(Z, u_stage)
        (Jf,) = _stage_jacobians(f, Z, u, (0,))
        K = K - irk_newton_solve_ref(Jf, A, h, R.unsqueeze(-1)).squeeze(-1)
    phi = x + h * _ordered_sum(b[:, None] * K, -2)
    if not sensitivities:
        return phi
    Z = _stage_states(x, K, A, h)
    Jf, Ju = _stage_jacobians(f, Z, u, (0, 1))
    dK = irk_newton_solve_ref(Jf, A, h, torch.cat([Jf, Ju], dim=-1))
    eye = torch.eye(nx, dK.shape[-1], dtype=x.dtype, device=x.device)
    return phi, eye + h * _ordered_sum(b[:, None, None] * dK, -3)


def irk_step(f: Callable, x: torch.Tensor, u: torch.Tensor, dt, *,
             stages: int = 4, newton_iter: int = 3,
             tableau: str = "gauss_legendre", num_steps: int = 1,
             sensitivities: bool = False):
    """One implicit-RK step of size ``dt``, optionally split into
    ``num_steps`` substeps.

    Solves K_i = f(x + h sum_j A_ij K_j, u) with exactly ``newton_iter``
    full-Newton iterations on K (..., s, nx), starting from K_i = f(x, u);
    each iteration rebuilds the Jacobian of f at the current stage states
    and solves the (s nx x s nx) Newton system by the JAX package's block LU
    without pivoting. CPU tensors run the plain version (:func:`irk_step_ref`);
    CUDA tensors launch kernel K3 once for the whole step
    (:func:`irk_step_fused`), which takes ``f`` = the unicycle's
    ``models.unicycle.dynamics`` only and raises on anything it does not
    take. Each row's arithmetic is its own, so a row gives the same result
    whatever batch it runs in.

    Returns Phi (..., nx), or with ``sensitivities`` (Phi, D), D =
    dPhi/d(x, u) (..., nx, nx + nu) from the implicit-function theorem
    (chained over the substeps). The step is not differentiated by
    ``torch.func``: its sensitivities come from ``sensitivities``.
    """
    A, b = _tableau_tensors(tableau, stages, x.dtype, x.device)
    h = dt / num_steps
    lead, nx, nu = x.shape[:-1], x.shape[-1], u.shape[-1]
    x, u = x.reshape(-1, nx), u.expand(lead + (nu,)).reshape(-1, nu)
    if x.device.type == "cpu":
        out = irk_step_ref(x, u, A, b, h, newton_iter, num_steps, sensitivities, f=f)
    elif x.device.type == "cuda":
        from doa_mpc_tpu_torch.models.unicycle import dynamics

        if f is not dynamics:
            raise ValueError(f"kernel K3 integrates models.unicycle.dynamics only, not {f!r}")
        out = irk_step_fused(x, u, A, b, h, newton_iter, num_steps, sensitivities)
    else:
        raise ValueError(f"irk_step: unsupported device {x.device}")
    if not sensitivities:
        return out.reshape(lead + (nx,))
    phi, D = out
    return phi.reshape(lead + (nx,)), D.reshape(lead + D.shape[-2:])


def irk_step_ref(x: torch.Tensor, u: torch.Tensor, A: torch.Tensor, b: torch.Tensor, h,
                 newton_iter: int, num_steps: int, sensitivities: bool, f: Callable = None):
    """Plain version of kernel K3 (:func:`irk_step_fused`, the same
    arguments): ``num_steps`` :func:`_irk_substep` calls of size ``h`` over
    rows x (R, nx), u (R, nu), D chained by products; ``f`` defaults to the
    unicycle's dynamics. :func:`irk_step` calls it on CPU tensors only."""
    if f is None:
        from doa_mpc_tpu_torch.models.unicycle import dynamics as f
    nx = x.shape[-1]
    D = None
    for _ in range(num_steps):
        if not sensitivities:
            x = _irk_substep(f, x, u, h, A, b, newton_iter, False)
            continue
        x, Ds = _irk_substep(f, x, u, h, A, b, newton_iter, True)
        D = Ds if D is None else torch.cat(
            [Ds[..., :nx] @ D[..., :nx], Ds[..., :nx] @ D[..., nx:] + Ds[..., nx:]], dim=-1)
    return x if D is None else (x, D)


# ---------------------------------------------------------------------------
# Kernel K3: the whole IRK step of the unicycle on the card
# ---------------------------------------------------------------------------

KERNEL_SOURCE = os.path.join(cuda_build.CSRC_DIR, "irk_step.cu")
K3_STAGES, K3_NX, K3_NU = (1, 2, 3, 4), 5, 2


def bind_library(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points of a build of ``csrc/irk_step.cu`` (the
    package's, or one per team size in ``scripts/k3_team.py``)."""
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    step = (i32, [ptr, ptr, ptr, ptr, ctypes.c_double, i32, i32, ptr, ptr, i64, i32, ptr])
    return cuda_build.declare(lib, "irk_step", {
        "f32": step, "f64": step,
        "plan": (i32, [i32, i32, i32, ctypes.POINTER(i64), ctypes.POINTER(i32)]),
        "team": (i32, []), "rows_per_block": (i32, [])})


@functools.lru_cache(maxsize=None)
def _library():
    return bind_library(ctypes.CDLL(cuda_build.build(KERNEL_SOURCE)))


class K3Plan(NamedTuple):
    """K3's launch shape for one instantiation on one card."""
    team: int            # lanes per row
    rows_per_block: int
    smem_bytes: int      # shared memory per block
    blocks_per_sm: int   # blocks resident per SM (occupancy API)


@functools.lru_cache(maxsize=None)
def _plan(lib, device: int, stages: int, sensitivities: bool, dtype: torch.dtype) -> K3Plan:
    smem, per_sm = ctypes.c_longlong(), ctypes.c_int()
    with torch.cuda.device(device):
        rc = lib.irk_step_plan(stages, int(sensitivities), int(dtype == torch.float64),
                               ctypes.byref(smem), ctypes.byref(per_sm))
    cuda_build.check(lib, "irk_step", rc, f"irk_step_plan failed (s={stages})")
    return K3Plan(lib.irk_step_team(), lib.irk_step_rows_per_block(), smem.value, per_sm.value)


def plan(stages: int, sensitivities: bool, dtype: torch.dtype, lib=None) -> K3Plan:
    """K3's launch shape for one instantiation on the current card, made
    once per card and instantiation. Making it sets the instantiation's
    shared-memory limit, which its launches rely on. ``lib``: another build
    of the source, bound by :func:`bind_library`; by default the package's."""
    return _plan(lib or _library(), torch.cuda.current_device(), stages, sensitivities, dtype)


def _check_k3_inputs(x, u, A, b, newton_iter, num_steps) -> None:
    """Raise on what kernel K3 does not take: a dtype other than float32 or
    float64, mixed dtypes or devices, shapes other than x (R, 5), u (R, 2),
    A (s, s) and b (s,) with s in 1-4, a negative Newton iteration count or
    no substep."""
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"kernel K3 takes float32 or float64; x is {x.dtype}")
    for name, t in (("u", u), ("A", A), ("b", b)):
        if t.dtype != x.dtype:
            raise TypeError(f"{name} is {t.dtype}, x is {x.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if x.ndim != 2 or x.shape[1] != K3_NX or tuple(u.shape) != (x.shape[0], K3_NU):
        raise ValueError(f"kernel K3 is built for nx = {K3_NX} and nu = {K3_NU}; got "
                         f"x {tuple(x.shape)} and u {tuple(u.shape)}")
    s = A.shape[0]
    if s not in K3_STAGES or tuple(A.shape) != (s, s) or tuple(b.shape) != (s,):
        raise ValueError(f"kernel K3 is built for s in {K3_STAGES}; got A {tuple(A.shape)} "
                         f"and b {tuple(b.shape)}")
    if newton_iter < 0 or num_steps < 1:
        raise ValueError(f"newton_iter = {newton_iter} and num_steps = {num_steps}: need "
                         f">= 0 and >= 1")


def irk_step_fused(x: torch.Tensor, u: torch.Tensor, A: torch.Tensor, b: torch.Tensor, h,
                   newton_iter: int, num_steps: int, sensitivities: bool):
    """Kernel K3: ``num_steps`` IRK substeps of size ``h`` of the unicycle
    over rows x (R, 5), u (R, 2) on the card, with tableau A (s, s), b (s)
    in the rows' dtype: Phi (R, 5), and with ``sensitivities`` also D =
    dPhi/d(x, u) (R, 5, 7). One launch (a team of lanes per row, the
    blocks in shared memory), counted in ``irk_step_fused.launches``. It
    raises on a tensor off the card and on what the kernel does not take
    (:func:`_check_k3_inputs`); there is no fallback."""
    if x.device.type != "cuda":
        raise ValueError(f"kernel K3 runs on a CUDA device, not {x.device}")
    _check_k3_inputs(x, u, A, b, newton_iter, num_steps)
    x, u, A, b = (t.contiguous() for t in (x, u, A, b))
    rows = x.shape[0]
    phi = torch.empty_like(x)
    D = torch.empty((rows, K3_NX, K3_NX + K3_NU), dtype=x.dtype, device=x.device) \
        if sensitivities else None
    if rows == 0:
        return (phi, D) if sensitivities else phi
    lib = _library()
    _plan(lib, x.device.index, A.shape[0], sensitivities, x.dtype)   # its attribute, once
    cuda_build.launch(
        lib, "irk_step", "f32" if x.dtype == torch.float32 else "f64", x.device,
        x.data_ptr(), u.data_ptr(), A.data_ptr(), b.data_ptr(), float(h), newton_iter, num_steps,
        phi.data_ptr(), D.data_ptr() if sensitivities else None, rows, A.shape[0],
        what=f"irk_step launch failed (rows={rows}, s={A.shape[0]}, newton_iter={newton_iter}, "
             f"num_steps={num_steps})")
    irk_step_fused.launches += 1
    return (phi, D) if sensitivities else phi


irk_step_fused.launches = 0


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


def make_linearization(options) -> Callable:
    """Build lin(x, u, dt) -> (Phi, dPhi/dx, dPhi/du) over rows x (R, nx),
    u (R, nu) from :class:`doa_mpc_tpu_torch.config.SolverOptions`: rk4
    through ``vmap(jacfwd(...))`` with Phi as its aux output, inside the
    span ``doa.rk4_lin``; IRK from one :func:`irk_step` with its IFT
    sensitivities (on the card one launch of kernel K3 over all rows)."""
    from doa_mpc_tpu_torch.models.unicycle import dynamics

    if options.integrator == "irk":
        def lin(x, u, dt):
            phi, D = irk_step(dynamics, x, u, dt, stages=options.irk_stages,
                              newton_iter=options.irk_newton_iter,
                              tableau=options.irk_tableau, sensitivities=True)
            nx = x.shape[-1]
            return phi, D[..., :nx], D[..., nx:]
        return lin
    step = make_integrator(options)

    def phi_twice(x, u, dt):
        phi = step(x, u, dt)
        return phi, phi

    jac = vmap(jacfwd(phi_twice, argnums=(0, 1), has_aux=True), in_dims=(0, 0, None))

    def lin(x, u, dt):
        with span("doa.rk4_lin"):
            (A, B), phi = jac(x, u, dt)
        return phi, A, B
    return lin
