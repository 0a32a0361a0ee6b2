"""The batched tick's glue without host copies: the IDXBX gather and scatter,
the forecast's box bounds made once per device, and ``build_qp``'s stage
scale written by a fill. Each gives, bit for bit, what the list index, the
fresh ``torch.tensor`` and the Python number written into ``sc[-1]`` gave
(on the card those copied from the host and made it wait)."""

import functools

import pytest
import torch

from doa_mpc_tpu_torch.config import SolverOptions, WorldSpec, default_cost_params
from doa_mpc_tpu_torch.ops.ocp_qp import IDXBX, gather_idxbx, scatter_idxbx
from doa_mpc_tpu_torch.sim import obstacles
from doa_mpc_tpu_torch.sim.obstacles import ObstacleState, predict_trajectory
from doa_mpc_tpu_torch.solver.sqp_rti import RtiState, make_rti_controller

DTYPES = pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
LEADS = pytest.mark.parametrize("lead", [(), (3, 7)], ids=["unbatched", "batched"])


def _randn(shape, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g, dtype=torch.float64).to(dtype)


@DTYPES
@LEADS
def test_gather_idxbx_equals_list_indexing(dtype, lead):
    v = _randn(lead + (5,), dtype)
    v[..., 1] = -0.0                      # the sign of a zero is kept too
    got, want = gather_idxbx(v), v[..., list(IDXBX)]
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))


@DTYPES
@LEADS
def test_scatter_idxbx_equals_list_indexing(dtype, lead):
    vals = _randn(lead + (len(IDXBX),), dtype, seed=1)
    vals[..., 2] = -0.0
    want = torch.zeros(lead + (5,), dtype=dtype)
    want[..., list(IDXBX)] = vals
    got = scatter_idxbx(vals, 5)
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
    assert torch.equal(gather_idxbx(got), vals)


def _fold_with_fresh_bounds(state, spec, n):
    """The forecast's expressions with the bounds built anew by
    ``torch.tensor`` on every call (the form the cached bounds replace)."""
    pos = state.pos
    t = (torch.arange(n + 1, dtype=pos.dtype, device=pos.device) * spec.dt).reshape(
        (n + 1,) + (1,) * pos.ndim)
    lo = torch.tensor([spec.x_min, spec.y_min], dtype=pos.dtype, device=pos.device)
    hi = torch.tensor([spec.x_max, spec.y_max], dtype=pos.dtype, device=pos.device)
    period = 2.0 * (hi - lo)
    free = (pos - lo)[None] + t * state.vel[None]
    y = torch.remainder(free, period)
    return lo + torch.minimum(y, period - y)


@DTYPES
def test_predict_trajectory_with_cached_bounds_is_bitwise_the_fresh_form(dtype):
    spec = WorldSpec(tf=2.0, n_solv=20, n_obst=5)
    n = spec.n_solv
    for call in range(2):                 # the first call fills the cache, the second reads it
        state = ObstacleState(_randn((4, 5, 2), dtype, seed=2 + call) * 9.0,
                              _randn((4, 5, 2), dtype, seed=4 + call) * 2.0)
        hits = obstacles._box.cache_info().hits
        got = predict_trajectory(state, spec, n)
        want = _fold_with_fresh_bounds(state, spec, n)
        assert got.dtype == dtype and torch.equal(got, want)
        if call:
            assert obstacles._box.cache_info().hits == hits + 1
    lo, hi = obstacles._box(spec.x_min, spec.y_min, spec.x_max, spec.y_max, dtype,
                            torch.device("cpu"))
    assert lo.tolist() == [spec.x_min, spec.y_min] and hi.tolist() == [spec.x_max, spec.y_max]


@DTYPES
@pytest.mark.parametrize("cost_scale_dt", [True, False], ids=["dt", "one"])
def test_build_qp_stage_scale_is_dt_on_path_stages_and_one_at_the_end(dtype, cost_scale_dt):
    """``sc`` reaches the QP through q: q_k = sc_k (w_k * (x_k - yref)), with
    sc_k = dt (or 1 without ``cost_scale_dt``) on path stages and 1 at N."""
    N, M, B = 6, 3, 4
    spec = WorldSpec(tf=0.1 * N, n_solv=N, n_obst=M, qp_iter=6)
    opts = SolverOptions(qp_iter=6, integrator="rk4", cost_scale_dt=cost_scale_dt)
    ctrl = make_rti_controller(spec, opts, dtype=dtype, device="cpu")
    params = default_cost_params(spec, dtype=dtype, device="cpu")
    xg = _randn((B, N + 1, 5), dtype, seed=6) * 3.0
    ug = _randn((B, N, 2), dtype, seed=7)
    x0 = xg[:, 0] + 0.1
    goal = torch.tensor([7.0, 7.0], dtype=dtype)
    pred = _randn((B, N + 1, M, 2), dtype, seed=8) * 5.0
    qp = ctrl.build_qp(RtiState(xg, ug), x0, goal, pred, params)

    sc = torch.full((N + 1,), spec.tf / N if cost_scale_dt else 1.0, dtype=dtype)
    sc[-1] = 1.0
    w_q = torch.zeros(5, dtype=dtype)
    w_q[list(IDXBX)] = params.q_diag
    w_qe = torch.zeros(5, dtype=dtype)
    w_qe[list(IDXBX)] = params.qe_diag
    w_stage = torch.cat([w_q.expand(N, 5), w_qe[None]], 0)
    yref = torch.zeros(5, dtype=dtype)
    yref[0], yref[1] = goal[0], goal[1]
    assert torch.equal(qp.q, sc[:, None] * (w_stage * (xg - yref)))
    assert torch.equal(qp.r, sc[:-1, None] * params.r_diag * ug)


def test_box_cache_is_keyed_by_dtype():
    spec = WorldSpec()
    key = functools.partial(obstacles._box, spec.x_min, spec.y_min, spec.x_max, spec.y_max)
    lo32, _ = key(torch.float32, torch.device("cpu"))
    lo64, _ = key(torch.float64, torch.device("cpu"))
    assert lo32.dtype == torch.float32 and lo64.dtype == torch.float64
    assert key(torch.float32, torch.device("cpu"))[0] is lo32
