"""The PyTorch port's implicit Runge-Kutta integrator against the JAX
package's in float64: the tableaus, the step (1e-12), its IFT sensitivities
under ``torch.func.jacfwd`` (1e-10 against ``jax.jacfwd``, 1e-6 against
finite differences), the native C++ Radau IIA step as a third oracle, f32
against f64, and one factorization of the Newton matrix per stage point
under the controller's linearization."""

import os
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
from doa_mpc_tpu.ops.integrators import butcher_tableau as j_tableau
from doa_mpc_tpu.ops.integrators import irk_step as j_irk
from doa_mpc_tpu_torch.config import SolverOptions, WorldSpec
from doa_mpc_tpu_torch.models.unicycle import dynamics
from doa_mpc_tpu_torch.ops.integrators import butcher_tableau, irk_step, make_integrator
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
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-12)


@pytest.mark.parametrize("kind,stages", SCHEMES)
@pytest.mark.parametrize("num_steps", [1, 2])
def test_irk_sensitivities_match_jax_jacfwd_and_finite_differences(kind, stages, num_steps):
    x, u = _states(1)

    def j_step(xx, uu):
        return j_irk(j_dynamics, xx, uu, DT, stages=stages, tableau=kind,
                     num_steps=num_steps)

    def step(xx, uu):
        return irk_step(dynamics, xx, uu, DT, stages=stages, tableau=kind,
                        num_steps=num_steps)

    A_j, B_j = jax.jit(jax.vmap(jax.jacfwd(j_step, argnums=(0, 1))))(jnp.asarray(x),
                                                                      jnp.asarray(u))
    xt, ut = torch.as_tensor(x), torch.as_tensor(u)
    A, B = vmap(jacfwd(step, argnums=(0, 1)))(xt, ut)
    np.testing.assert_allclose(A.numpy(), np.asarray(A_j), rtol=0, atol=1e-10)
    np.testing.assert_allclose(B.numpy(), np.asarray(B_j), rtol=0, atol=1e-10)
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
    """Under ``vmap(jacfwd(...))`` the 7 tangent directions share one
    factorization: the linearization of all B*N stage points calls the LU
    as often as one plain step over them does (newton_iter + 1 times, each
    over the whole batch), not 7 times as often."""
    spec = WorldSpec(tf=0.4, n_solv=4, n_obst=2, qp_iter=2)
    ctrl = make_rti_controller(spec, dtype=torch.float64, device="cpu")
    assert ctrl.options.integrator == "irk" and ctrl.options.irk_newton_iter == 3
    x, u = _states(5, nb=12)
    xs, us = torch.as_tensor(x).reshape(3, 4, 5), torch.as_tensor(u).reshape(3, 4, 2)
    calls = []
    lu_factor_ex = torch.linalg.lu_factor_ex

    def spy(M, *a, **k):
        calls.append(M.shape)
        return lu_factor_ex(M, *a, **k)

    monkeypatch.setattr(torch.linalg, "lu_factor_ex", spy)
    plain = ctrl.integrate(xs, us)
    assert calls == [(3, 4, 20, 20)] * 4
    calls.clear()
    phi, A, B = ctrl.lin(xs, us)
    assert len(calls) == 4
    np.testing.assert_array_equal(phi.numpy(), plain.numpy())
    assert A.shape == (3, 4, 5, 5) and B.shape == (3, 4, 5, 2)


def test_tf32_stays_off_after_import():
    """The f32 einsums and solves need full-precision products on the card."""
    code = ("import torch, doa_mpc_tpu_torch.ops.integrators\n"
            "assert torch.backends.cuda.matmul.allow_tf32 is False\n"
            "assert torch.backends.cudnn.allow_tf32 is False\n"
            "assert torch.get_float32_matmul_precision() == 'highest'\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, env=dict(os.environ, PYTHONPATH=REPO))
    assert res.returncode == 0, res.stderr
