"""The PyTorch port stands apart from JAX, and its CUDA paths never fall
back to the CPU on their own."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "doa_mpc_tpu_torch")


def _py_files():
    for root, _, files in os.walk(PKG):
        if "_build" in root:
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def test_import_loads_no_jax():
    modules = sorted(
        "doa_mpc_tpu_torch." + os.path.relpath(p, PKG)[:-3].replace(os.sep, ".")
        for p in _py_files() if not p.endswith(("__init__.py", "__main__.py")))
    code = ("import sys, importlib, doa_mpc_tpu_torch\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m.startswith('doa_mpc_tpu.') or m == 'doa_mpc_tpu'"
            " or m.split('.')[0] in ('matplotlib', 'flax', 'optax'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert len(modules) >= 14 and "doa_mpc_tpu_torch.sim.parity" in modules


def test_no_source_file_imports_jax():
    pat = re.compile(r"^\s*(import\s+jax|from\s+jax)\b|^\s*(import|from)\s+doa_mpc_tpu\b",
                     re.M)
    offenders = [p for p in _py_files() if pat.search(open(p).read())]
    assert not offenders, offenders


def test_cuda_default_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is valid")
    from doa_mpc_tpu_torch.config import SolverOptions, WorldSpec, default_cost_params
    from doa_mpc_tpu_torch.sim.experiments import run_scenario_batch
    from doa_mpc_tpu_torch.solver.sqp_rti import make_rti_controller

    spec = WorldSpec(tf=0.3, n_solv=3, n_obst=2, qp_iter=1)
    opts = SolverOptions(qp_iter=1, integrator="rk4")
    with pytest.raises(RuntimeError, match="cuda"):
        default_cost_params(spec)
    with pytest.raises(RuntimeError, match="cuda"):
        make_rti_controller(spec, opts)
    with pytest.raises(RuntimeError, match="cuda"):
        run_scenario_batch(spec, opts, "RANDOM", n_runs=1, max_iter=1)


def test_irk_integrator_raises_not_implemented():
    """IRK, the default integrator, is ported: the default options build a
    controller, and only an integrator that neither package has raises."""
    from doa_mpc_tpu_torch.config import SolverOptions, WorldSpec
    from doa_mpc_tpu_torch.solver.sqp_rti import make_rti_controller

    ctrl = make_rti_controller(WorldSpec(), SolverOptions(), device="cpu")
    assert ctrl.options.integrator == "irk"
    x = ctrl.integrate(torch.zeros(2, 5, dtype=torch.float32), torch.ones(2, 2))
    assert x.shape == (2, 5) and bool(torch.isfinite(x).all())
    with pytest.raises(ValueError, match="unknown integrator"):
        make_rti_controller(WorldSpec(), SolverOptions(integrator="euler"), device="cpu")


def test_cpu_tensor_runs_plain_version_and_counts_no_launch():
    from doa_mpc_tpu_torch.ops.ip_fused import (
        solve_ocp_qp_fused, solve_ocp_qp_fused_ref)
    from doa_mpc_tpu_torch.ops.ocp_qp import OcpQp
    from test_torch_ip_fused import random_qps

    qp = random_qps(2, torch.float32)
    solve_ocp_qp_fused.launches = 0
    sol = solve_ocp_qp_fused(qp, iters=2)
    assert solve_ocp_qp_fused.launches == 0
    ref = solve_ocp_qp_fused_ref(qp, iters=2)
    for a, b in zip(sol, ref):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert isinstance(qp, OcpQp)
