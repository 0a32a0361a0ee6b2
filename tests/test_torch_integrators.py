"""The PyTorch port's implicit Runge-Kutta integrator against the JAX
package's in float64: the tableaus; the block LU of the Newton matrix
(``_inv_small``, ``_newton_blocks``, ``_block_lu``, ``_block_solve``: 1e-13
in f64, 1e-5 in f32, against the JAX functions of the same names); the step
(1e-14; 3.3e-16 measured), its IFT sensitivities (1e-15 against
``jax.jacfwd``; 5.6e-17 measured; 1e-6 against finite differences) and the
controller's linearization (1e-13 against JAX's ``vmap(jacfwd(...))``); the
native C++ Radau IIA step as a third oracle; f32 against f64; kernel K3's
source (the whole step) compiled with g++ against the plain step and
JAX's, and its input checks; the Newton matrix
factored once per Newton iteration over all rows (plus once for the
sensitivities of the linearization); and the sharded IRK rollout."""

import ctypes
import os
import shutil
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch.func import jacfwd, vmap

from doa_mpc_tpu import native
from doa_mpc_tpu.models.unicycle import dynamics as j_dynamics
from doa_mpc_tpu.ops import integrators as j_int
from doa_mpc_tpu.ops.integrators import butcher_tableau as j_tableau
from doa_mpc_tpu.ops.integrators import irk_step as j_irk
from doa_mpc_tpu.solver.sqp_rti import make_rti_controller as j_make_rti_controller
from doa_mpc_tpu_torch.config import SolverOptions, WorldSpec
from doa_mpc_tpu_torch.models.unicycle import dynamics
from doa_mpc_tpu_torch.ops import integrators
from doa_mpc_tpu_torch.ops.integrators import (
    butcher_tableau, irk_newton_solve_ref, irk_step, make_integrator)
from doa_mpc_tpu_torch.parallel.mesh import make_data_mesh
from doa_mpc_tpu_torch.sim.experiments import run_scenario_batch
from doa_mpc_tpu_torch.solver.sqp_rti import make_rti_controller

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NB, DT = 16, 0.1
SCHEMES = [("gauss_legendre", 4), ("radau_iia", 3)]


def _states(seed=0, nb=NB):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((nb, 5)) * np.array([3, 3, 2, 2, 1])
    u = rng.standard_normal((nb, 2)) * 3
    return x, u


@pytest.mark.parametrize("kind,stages", [("gauss_legendre", s) for s in (1, 2, 3, 4)]
                         + [("radau_iia", s) for s in (1, 2, 3)])
def test_tableaus_equal_jax(kind, stages):
    for got, want in zip(butcher_tableau(kind, stages), j_tableau(kind, stages)):
        np.testing.assert_array_equal(got, want)


def test_tableau_rejects_unknown_schemes():
    with pytest.raises(ValueError, match="stages<=3"):
        butcher_tableau("radau_iia", 4)
    with pytest.raises(ValueError, match="unknown tableau"):
        butcher_tableau("lobatto", 2)


@pytest.mark.parametrize("kind,stages", SCHEMES)
@pytest.mark.parametrize("num_steps", [1, 2])
def test_irk_step_matches_jax(kind, stages, num_steps):
    x, u = _states()
    want = j_irk(j_dynamics, jnp.asarray(x), jnp.asarray(u), DT, stages=stages,
                 tableau=kind, num_steps=num_steps)
    got = irk_step(dynamics, torch.as_tensor(x), torch.as_tensor(u), DT, stages=stages,
                   tableau=kind, num_steps=num_steps)
    assert got.dtype == torch.float64 and got.shape == (NB, 5)
    # the same block LU in the same order: 3.3e-16 measured
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-14)


@pytest.mark.parametrize("kind,stages", SCHEMES)
@pytest.mark.parametrize("num_steps", [1, 2])
def test_irk_sensitivities_match_jax_jacfwd_and_finite_differences(kind, stages, num_steps):
    """``irk_step(..., sensitivities=True)``'s IFT D = dPhi/d(x, u) (chained
    over the substeps) against ``jax.jacfwd`` of JAX's step (5.6e-17
    measured) and against central differences of the port's step."""
    x, u = _states(1)

    def j_step(xx, uu):
        return j_irk(j_dynamics, xx, uu, DT, stages=stages, tableau=kind,
                     num_steps=num_steps)

    def step(xx, uu, **kw):
        return irk_step(dynamics, xx, uu, DT, stages=stages, tableau=kind,
                        num_steps=num_steps, **kw)

    A_j, B_j = jax.jit(jax.vmap(jax.jacfwd(j_step, argnums=(0, 1))))(jnp.asarray(x),
                                                                      jnp.asarray(u))
    xt, ut = torch.as_tensor(x), torch.as_tensor(u)
    phi, D = step(xt, ut, sensitivities=True)
    A, B = D[..., :5], D[..., 5:]
    np.testing.assert_array_equal(phi.numpy(), step(xt, ut).numpy())
    np.testing.assert_allclose(A.numpy(), np.asarray(A_j), rtol=0, atol=1e-15)
    np.testing.assert_allclose(B.numpy(), np.asarray(B_j), rtol=0, atol=1e-15)
    # central differences of the step itself (the Newton residual after 3
    # iterations sits far below the 1e-6 tolerance)
    eps = 1e-6
    for k in range(7):
        e = torch.zeros(7, dtype=torch.float64)
        e[k] = eps
        fd = (step(xt + e[:5], ut + e[5:]) - step(xt - e[:5], ut - e[5:])) / (2 * eps)
        col = A[..., k] if k < 5 else B[..., k - 5]
        np.testing.assert_allclose(col.numpy(), fd.numpy(), rtol=0, atol=1e-6)


def test_radau3_matches_native_irk3():
    if not native.available():
        pytest.skip("native library unavailable")
    x, u = _states(2, nb=6)
    got = irk_step(dynamics, torch.as_tensor(x), torch.as_tensor(u), DT, stages=3,
                   newton_iter=10, tableau="radau_iia")
    for i in range(len(x)):
        # the native step runs functional iterations: 60 reach its fixed point
        want = native.irk3_step(x[i], u[i], DT, iters=60)
        np.testing.assert_allclose(got[i].numpy(), want, rtol=0, atol=1e-12)


def test_irk_f32_within_1e5_of_f64():
    x, u = _states(3)
    x[:, 2] = np.clip(x[:, 2], -3.0, 3.0)
    got32 = irk_step(dynamics, torch.tensor(x, dtype=torch.float32),
                     torch.tensor(u, dtype=torch.float32), DT)
    got64 = irk_step(dynamics, torch.as_tensor(x), torch.as_tensor(u), DT)
    assert got32.dtype == torch.float32
    np.testing.assert_allclose(got32.double().numpy(), got64.numpy(), rtol=0, atol=1e-5)


def test_make_integrator_builds_the_options_scheme():
    x, u = _states(4)
    xt, ut = torch.as_tensor(x), torch.as_tensor(u)
    opts = SolverOptions(irk_stages=3, irk_newton_iter=2, irk_tableau="radau_iia")
    got = make_integrator(opts)(xt, ut, DT)
    want = irk_step(dynamics, xt, ut, DT, stages=3, newton_iter=2, tableau="radau_iia")
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    with pytest.raises(ValueError, match="unknown integrator"):
        make_integrator(SolverOptions(integrator="euler"))


def test_lin_factors_the_newton_matrix_once_per_stage_point(monkeypatch):
    """The linearization of all B*N stage points is one batch of rows: it
    factors the Newton matrix once per Newton iteration and once more for
    the sensitivities (newton_iter + 1 calls of ``_block_lu``, each over
    every row), whatever the number of tangent directions; the plant step
    once per Newton iteration (it solves no sensitivities)."""
    spec = WorldSpec(tf=0.4, n_solv=4, n_obst=2, qp_iter=2)
    ctrl = make_rti_controller(spec, dtype=torch.float64, device="cpu")
    assert ctrl.options.integrator == "irk" and ctrl.options.irk_newton_iter == 3
    x, u = _states(5, nb=12)
    xs, us = torch.as_tensor(x).reshape(3, 4, 5), torch.as_tensor(u).reshape(3, 4, 2)
    calls = []
    block_lu = integrators._block_lu

    def spy(M):
        calls.append(tuple(M.shape))
        return block_lu(M)

    monkeypatch.setattr(integrators, "_block_lu", spy)
    plain = ctrl.integrate(xs, us)
    assert calls == [(12, 4, 4, 5, 5)] * 3
    calls.clear()
    phi, A, B = ctrl.lin(xs, us)
    assert calls == [(12, 4, 4, 5, 5)] * 4
    np.testing.assert_array_equal(phi.numpy(), plain.numpy())
    assert A.shape == (3, 4, 5, 5) and B.shape == (3, 4, 5, 2)


@pytest.mark.parametrize("integrator", ["irk", "rk4"])
def test_lin_matches_jax_vmap_jacfwd_linearization(integrator):
    """The controller's (Phi, A, B) over B x N stage points against JAX's
    controller, which differentiates its step with ``jax.jacfwd`` under
    ``jax.vmap``, in f64 (IRK: the IFT sensitivities of one Newton solve
    of all rows; rk4: ``vmap(jacfwd(...))`` here too)."""
    spec = WorldSpec(tf=2.0, n_solv=20, n_obst=5, qp_iter=6)
    opts = SolverOptions(qp_iter=6, integrator=integrator)
    x, u = _states(6, nb=60)
    xs, us = x.reshape(3, 20, 5), u.reshape(3, 20, 2)
    got = make_rti_controller(spec, opts, dtype=torch.float64, device="cpu").lin(
        torch.as_tensor(xs), torch.as_tensor(us))
    j_lin = jax.jit(jax.vmap(j_make_rti_controller(spec, opts, dtype=jnp.float64).lin))
    want = j_lin(jnp.asarray(xs), jnp.asarray(us))
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-13)


def test_lin_takes_a_view_at_a_storage_offset():
    """A shard's stage arrays are views into the whole batch's (rows 2..3 of
    4): the IRK linearization takes them and gives the rows of the whole."""
    spec = WorldSpec(tf=0.4, n_solv=4, n_obst=2, qp_iter=2)
    ctrl = make_rti_controller(spec, dtype=torch.float64, device="cpu")
    x, u = _states(7, nb=16)
    xs, us = torch.as_tensor(x).reshape(4, 4, 5), torch.as_tensor(u).reshape(4, 4, 2)
    whole = ctrl.lin(xs, us)
    part = ctrl.lin(xs[2:], us[2:])
    assert us[2:].storage_offset() > 0
    for w, p in zip(whole, part):
        np.testing.assert_array_equal(p.numpy(), w[2:].numpy())


def test_irk_sharded_rollout_rows_equal_unsharded():
    """An IRK campaign over a 2-device mesh gives the unsharded rows (each
    shard's linearization takes its rows as views into the batch)."""
    spec = WorldSpec(tf=0.5, n_solv=5, n_obst=3, qp_iter=4)
    opts = SolverOptions(qp_iter=4)
    assert opts.integrator == "irk"
    kw = dict(n_runs=4, max_iter=4, dtype=torch.float64, device="cpu")
    whole = run_scenario_batch(spec, opts, "RANDOM", **kw)
    sharded = run_scenario_batch(spec, opts, "RANDOM",
                                 mesh=make_data_mesh([torch.device("cpu")] * 2), **kw)
    np.testing.assert_array_equal(sharded, whole)


# ---------------------------------------------------------------------------
# the block LU against the JAX functions, and kernel K3's source on the host
# ---------------------------------------------------------------------------

DTYPES = pytest.mark.parametrize("dtype,atol", [(np.float64, 1e-13), (np.float32, 1e-5)],
                                 ids=["f64", "f32"])


def _jf(seed, nb=6, s=4):
    """Stage Jacobians of the unicycle's size, entries N(0, 1)."""
    return np.random.default_rng(seed).standard_normal((nb, s, 5, 5))


def _t(a, dtype):
    return torch.as_tensor(a.astype(dtype))


@DTYPES
def test_inv_small_matches_jax(dtype, atol):
    D = np.eye(5) + 0.3 * np.random.default_rng(8).standard_normal((7, 5, 5))
    got = integrators._inv_small(_t(D, dtype))
    want = j_int._inv_small(jnp.asarray(D.astype(dtype)))
    assert got.dtype == _t(D, dtype).dtype
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=atol)
    np.testing.assert_allclose((got.double() @ torch.as_tensor(D)).numpy(),
                               np.broadcast_to(np.eye(5), D.shape), rtol=0, atol=10 * atol)


@DTYPES
@pytest.mark.parametrize("kind,stages", SCHEMES)
def test_newton_blocks_and_block_lu_match_jax(dtype, atol, kind, stages):
    A = butcher_tableau(kind, stages)[0].astype(dtype)
    Jf = _jf(9, s=stages).astype(dtype)
    M = integrators._newton_blocks(torch.as_tensor(A), torch.as_tensor(Jf), DT)
    Mj = j_int._newton_blocks(jnp.asarray(A), jnp.asarray(Jf), DT)
    np.testing.assert_allclose(M.numpy(), np.asarray(Mj), rtol=0, atol=atol)
    LU, invd = integrators._block_lu(M)
    LUj, invdj = j_int._block_lu(Mj)
    np.testing.assert_allclose(LU.numpy(), np.asarray(LUj), rtol=0, atol=atol)
    for g, w in zip(invd, invdj):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=atol)
    r = np.random.default_rng(10).standard_normal(Jf.shape[:-1]).astype(dtype)
    got = integrators._block_solve(LU, invd, torch.as_tensor(r))
    want = j_int._block_solve(LUj, invdj, jnp.asarray(r))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=atol)


@pytest.mark.parametrize("k", [1, 7])
def test_irk_newton_solve_solves_the_dense_system(k):
    """The plain block-LU solve against a dense solve of M = I - h (A (x) Jf)
    in f64, and each column as JAX's ``_block_solve`` solves one vector."""
    A = butcher_tableau("gauss_legendre", 4)[0]
    Jf = _jf(11)
    rhs = np.random.default_rng(12).standard_normal((6, 4, 5, k))
    At, Jt, rt = torch.as_tensor(A), torch.as_tensor(Jf), torch.as_tensor(rhs)
    got = irk_newton_solve_ref(Jt, At, DT, rt)
    assert got.shape == rhs.shape
    M = np.einsum("ij,nirc->nircj", -DT * A, Jf)           # (n, s, nx, nx, s)
    dense = np.eye(20) + np.transpose(M, (0, 1, 2, 4, 3)).reshape(6, 20, 20)
    np.testing.assert_allclose(got.reshape(6, 20, k).numpy(),
                               np.linalg.solve(dense, rhs.reshape(6, 20, k)), rtol=0, atol=1e-13)
    LUj, invdj = j_int._block_lu(j_int._newton_blocks(jnp.asarray(A), jnp.asarray(Jf), DT))
    for c in range(k):
        want = j_int._block_solve(LUj, invdj, jnp.asarray(rhs[..., c]))
        np.testing.assert_allclose(got[..., c].numpy(), np.asarray(want), rtol=0, atol=1e-13)


def test_k3_input_checks_raise():
    """What kernel K3 does not take raises before a launch: another dtype,
    width or stage count, mixed dtypes or devices, a negative Newton
    iteration count or no substep; a tensor off the card raises in the
    wrapper, and on neither the CPU nor a card in ``irk_step`` (no
    fallback)."""
    A, b = (torch.as_tensor(a) for a in butcher_tableau("gauss_legendre", 4)[:2])
    x, u = torch.zeros(3, 5, dtype=torch.float64), torch.zeros(3, 2, dtype=torch.float64)

    def check(x=x, u=u, A=A, b=b, newton_iter=3, num_steps=1):
        integrators._check_k3_inputs(x, u, A, b, newton_iter, num_steps)

    check()
    with pytest.raises(TypeError, match="float32 or float64"):
        check(x.half(), u.half(), A.half(), b.half())
    with pytest.raises(TypeError, match="u is"):
        check(u=u.float())
    with pytest.raises(ValueError, match="b is on"):
        check(b=b.to("meta"))
    with pytest.raises(ValueError, match="nx = 5 and nu = 2"):
        check(x=torch.zeros(3, 6, dtype=torch.float64))
    with pytest.raises(ValueError, match="nx = 5 and nu = 2"):
        check(u=torch.zeros(4, 2, dtype=torch.float64))
    with pytest.raises(ValueError, match="s in"):
        check(A=torch.zeros(5, 5, dtype=torch.float64), b=torch.zeros(5, dtype=torch.float64))
    with pytest.raises(ValueError, match="s in"):
        check(b=b[:3])
    with pytest.raises(ValueError, match="need"):
        check(newton_iter=-1)
    with pytest.raises(ValueError, match="need"):
        check(num_steps=0)
    with pytest.raises(ValueError, match="CUDA device"):
        integrators.irk_step_fused(x, u, A, b, DT, 3, 1, False)
    with pytest.raises(ValueError, match="unsupported device"):
        irk_step(dynamics, x.to("meta"), u.to("meta"), DT)


def test_irk_step_on_cpu_tensors_never_reaches_the_kernel(monkeypatch):
    """CPU tensors run the plain step, for any dynamics: the kernel's
    wrapper is not called."""
    def kernel(*a, **k):
        raise AssertionError("a CPU tensor reached kernel K3")

    monkeypatch.setattr(integrators, "irk_step_fused", kernel)
    x, u = (torch.as_tensor(a) for a in _states(15, nb=4))
    phi, D = irk_step(dynamics, x, u, DT, sensitivities=True)
    assert phi.shape == (4, 5) and D.shape == (4, 5, 7)
    irk_step(lambda s, c: 2.0 * dynamics(s, c), x, u, DT)


_HARNESS = """
#include "irk_step.cu"
extern "C" int host_irk_step_f64(const double* x, const double* u, const double* A,
                                 const double* b, double h, int newton_iter, int num_steps,
                                 double* phi, double* D, long long rows, int s, int reverse) {
  return irks::host_step<double>(s, x, u, A, b, h, newton_iter, num_steps, phi, D, rows,
                                 reverse != 0);
}
extern "C" int host_irk_step_f32(const float* x, const float* u, const float* A,
                                 const float* b, double h, int newton_iter, int num_steps,
                                 float* phi, float* D, long long rows, int s, int reverse) {
  return irks::host_step<float>(s, x, u, A, b, h, newton_iter, num_steps, phi, D, rows,
                                reverse != 0);
}
"""


@pytest.fixture(scope="module")
def host_k3(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("host_irk_step")
    src = d / "harness.cpp"
    src.write_text(_HARNESS)
    lib = d / "libhost.so"
    subprocess.run([gxx, "-std=c++17", "-O2", "-shared", "-fPIC",
                    "-I", os.path.dirname(integrators.KERNEL_SOURCE),
                    "-o", str(lib), str(src)], check=True, timeout=180)
    so = ctypes.CDLL(str(lib))
    for fn in (so.host_irk_step_f64, so.host_irk_step_f32):
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_double, ctypes.c_int, ctypes.c_int]
                       + [ctypes.c_void_p] * 2 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int])
        fn.restype = ctypes.c_int
    return so


def _host_step(so, x, u, kind, stages, newton_iter, num_steps, sensitivities, reverse=False):
    """Kernel K3's body built by g++ (``irks::host_step``: one lane per row,
    one row after another) on CPU tensors x (R, 5), u (R, 2): Phi, and D
    with ``sensitivities``; ``reverse`` walks each phase's items backwards."""
    A, b = integrators._tableau_tensors(kind, stages, x.dtype, x.device)
    phi = torch.full_like(x, float("nan"))
    D = torch.full((x.shape[0], 5, 7), float("nan"), dtype=x.dtype)
    fn = so.host_irk_step_f64 if x.dtype == torch.float64 else so.host_irk_step_f32
    rc = fn(x.data_ptr(), u.data_ptr(), A.data_ptr(), b.data_ptr(), DT / num_steps, newton_iter,
            num_steps, phi.data_ptr(), D.data_ptr() if sensitivities else None, x.shape[0],
            stages, int(reverse))
    assert rc == 0
    return (phi, D) if sensitivities else phi


ALL_SCHEMES = pytest.mark.parametrize(
    "kind,stages", [("gauss_legendre", s) for s in (1, 2, 3, 4)]
    + [("radau_iia", s) for s in (1, 2, 3)])


@pytest.mark.parametrize("dtype,atol", [(torch.float64, 1e-13), (torch.float32, 2e-5)],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("sensitivities", [False, True], ids=["phi", "sens"])
@pytest.mark.parametrize("num_steps", [1, 2])
@pytest.mark.parametrize("newton_iter", [1, 3])
@ALL_SCHEMES
def test_kernel_source_on_host_matches_plain(host_k3, kind, stages, newton_iter, num_steps,
                                             sensitivities, dtype, atol):
    """K3's body (``csrc/irk_step.cu``), built by g++, against the plain
    ``irk_step`` (Phi, and D with the sensitivities): 1e-13 in f64 (0
    measured: the same operations in the same order); in f32 2e-5, the
    rounding of the closed-form Jacobians' and the products' order
    (1.5e-8 measured). Walking each phase's items backwards gives the same
    bits: no item reads what another item of its phase writes, which is
    what lets the card's lanes share a phase."""
    x, u = (torch.as_tensor(a, dtype=dtype) for a in _states(16, nb=9))
    got = _host_step(host_k3, x, u, kind, stages, newton_iter, num_steps, sensitivities)
    back = _host_step(host_k3, x, u, kind, stages, newton_iter, num_steps, sensitivities,
                      reverse=True)
    want = irk_step(dynamics, x, u, DT, stages=stages, newton_iter=newton_iter, tableau=kind,
                    num_steps=num_steps, sensitivities=sensitivities)
    got, back, want = ((t,) if not sensitivities else t for t in (got, back, want))
    for g, bk, w in zip(got, back, want):
        assert torch.equal(g, bk)
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=atol)


@ALL_SCHEMES
def test_kernel_source_on_host_matches_jax_f64(host_k3, kind, stages):
    """K3's body in f64 against the JAX package's ``irk_step`` (Phi) and
    ``jax.jacfwd`` of it (D, through its ``custom_jvp`` rule), over two
    substeps (D chained): 1e-12."""
    x, u = _states(17, nb=6)

    def j_step(xx, uu):
        return j_irk(j_dynamics, xx, uu, DT, stages=stages, tableau=kind, num_steps=2)

    def j_phi_and_jac(xx, uu):
        return j_step(xx, uu), jax.jacfwd(j_step, argnums=(0, 1))(xx, uu)

    want_phi, (want_A, want_B) = jax.jit(jax.vmap(j_phi_and_jac))(jnp.asarray(x), jnp.asarray(u))
    phi, D = _host_step(host_k3, torch.as_tensor(x), torch.as_tensor(u), kind, stages, 3, 2,
                        True)
    np.testing.assert_allclose(phi.numpy(), np.asarray(want_phi), rtol=0, atol=1e-12)
    np.testing.assert_allclose(D[..., :5].numpy(), np.asarray(want_A), rtol=0, atol=1e-12)
    np.testing.assert_allclose(D[..., 5:].numpy(), np.asarray(want_B), rtol=0, atol=1e-12)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_kernel_source_on_host_rows_do_not_depend_on_the_batch(host_k3, dtype):
    """A row gives the same bits alone as inside a batch of 37 (the plant's
    and the linearization's shapes of call: Phi alone, and Phi with D)."""
    x, u = (torch.as_tensor(a, dtype=dtype) for a in _states(18, nb=37))
    for sens in (False, True):
        whole = _host_step(host_k3, x, u, "gauss_legendre", 4, 3, 1, sens)
        whole = whole if sens else (whole,)
        for r in (0, 17, 36):
            part = _host_step(host_k3, x[r:r + 1].clone(), u[r:r + 1].clone(),
                              "gauss_legendre", 4, 3, 1, sens)
            for p, w in zip(part if sens else (part,), whole):
                assert torch.equal(p, w[r:r + 1])


def test_kernel_source_on_host_rejects_what_it_does_not_build(host_k3):
    """The host entry returns -1 (the card's entry the same code) for a
    stage count outside 1-4, an empty batch, a negative Newton iteration
    count or no substep."""
    x, u = (torch.as_tensor(a) for a in _states(19, nb=2))
    A = torch.zeros(16, dtype=torch.float64)
    out, D = torch.empty(2, 5, dtype=torch.float64), torch.empty(2, 5, 7, dtype=torch.float64)
    fn = host_k3.host_irk_step_f64
    args = (x.data_ptr(), u.data_ptr(), A.data_ptr(), A.data_ptr(), DT)
    assert fn(*args, 3, 1, out.data_ptr(), D.data_ptr(), 2, 4, 0) == 0
    for it, ns, rows, s in ((3, 1, 2, 5), (3, 1, 2, 0), (3, 1, 0, 4), (-1, 1, 2, 4),
                            (3, 0, 2, 4)):
        assert fn(*args, it, ns, out.data_ptr(), D.data_ptr(), rows, s, 0) == -1


def test_tf32_stays_off_after_import():
    """The f32 einsums and solves need full-precision products on the card."""
    code = ("import torch, doa_mpc_tpu_torch.ops.integrators\n"
            "assert torch.backends.cuda.matmul.allow_tf32 is False\n"
            "assert torch.backends.cudnn.allow_tf32 is False\n"
            "assert torch.get_float32_matmul_precision() == 'highest'\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, env=dict(os.environ, PYTHONPATH=REPO))
    assert res.returncode == 0, res.stderr
