"""Kernels K1, K2 and K3 on a CUDA card against their plain PyTorch versions.

These tests need a card and skip without one. They import no JAX, so they
also run where only PyTorch is installed (tests/conftest.py imports JAX, so
such a machine runs them with ``--noconftest``):

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from doa_mpc_tpu_torch.config import SolverOptions, WorldSpec, default_cost_params
from doa_mpc_tpu_torch.ops import integrators, ip_fused, riccati_fused
from doa_mpc_tpu_torch.ops.ip_fused import (
    GENERIC_STRUCTURE, UNICYCLE_QP_STRUCTURE, solve_ocp_qp_fused, solve_ocp_qp_fused_ref)
from doa_mpc_tpu_torch.ops.ip_qp import solve_ocp_qp
from doa_mpc_tpu_torch.ops.ocp_qp import BIG_BOUND, OcpQp
from doa_mpc_tpu_torch.ops.riccati_fused import riccati_solve_fused, riccati_solve_fused_ref
from doa_mpc_tpu_torch.sim.closed_loop import init_loop_state, make_batched_tick
from doa_mpc_tpu_torch.sim.experiments import run_scenario_batch
from doa_mpc_tpu_torch.sim.obstacles import (
    ObstacleState, generate_obstacles, predict_trajectory, robot_start_goal)
from doa_mpc_tpu_torch.solver.sqp_rti import make_rti_controller
from doa_mpc_tpu_torch.utils import profiling

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "hard_qps_f32.npz")

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


STRUCTURES = pytest.mark.parametrize("structure", [GENERIC_STRUCTURE, UNICYCLE_QP_STRUCTURE],
                                     ids=["generic", "unicycle"])


def _qps(nb, N=20, M=5, seed=0, structure=GENERIC_STRUCTURE):
    """Random box- and soft-constrained OCP QPs (the recipe of
    tests/test_ip_qp._make_qp, batched), float32. With
    UNICYCLE_QP_STRUCTURE, Q and R are diagonal, A has identity columns 0
    and 1 and Zl == zl (S = 0 and C's columns 0, 1 hold for both)."""
    rng = np.random.default_rng(seed)
    nx, nu = 5, 2
    G = rng.standard_normal((nb, N + 1, nx, nx))
    H = rng.standard_normal((nb, N, nu, nu))
    lb_x = np.concatenate([-BIG_BOUND * np.ones((nb, 1, 4)), -1.5 * np.ones((nb, N - 1, 4)),
                           -BIG_BOUND * np.ones((nb, 1, 4))], 1)
    C = np.zeros((nb, N + 1, M, nx))
    C[..., :2] = rng.standard_normal((nb, N + 1, M, 2))
    qp = OcpQp(
        A=0.9 * np.eye(nx) + 0.05 * rng.standard_normal((nb, N, nx, nx)),
        B=0.3 * rng.standard_normal((nb, N, nx, nu)),
        c=0.1 * rng.standard_normal((nb, N, nx)),
        dx0=0.3 * rng.standard_normal((nb, nx)),
        Q=0.5 * G @ np.swapaxes(G, -1, -2) + np.eye(nx),
        q=2.0 * rng.standard_normal((nb, N + 1, nx)),
        R=0.5 * H @ np.swapaxes(H, -1, -2) + np.eye(nu),
        r=2.0 * rng.standard_normal((nb, N, nu)),
        S=np.zeros((nb, N, nu, nx)),
        lb_u=-0.4 * np.ones((nb, N, nu)), ub_u=0.4 * np.ones((nb, N, nu)),
        lb_x=lb_x, ub_x=-lb_x, C=C,
        hval=0.5 * rng.standard_normal((nb, N + 1, M)),
        zl=10.0 * np.ones((nb, N + 1, M)), Zl=20.0 * np.ones((nb, N + 1, M)))
    if structure == UNICYCLE_QP_STRUCTURE:
        eye = np.eye(nx)
        A = qp.A.copy()
        A[..., :, :2] = eye[:, :2]
        qp = qp._replace(A=A, Q=qp.Q * eye, R=qp.R * np.eye(nu), Zl=qp.zl)
    return OcpQp(*[torch.tensor(a, dtype=torch.float32) for a in qp])


def _to(qp, dev):
    return OcpQp(*[a.to(dev) for a in qp])


@STRUCTURES
@pytest.mark.parametrize("nb", [1, 37, 512])
def test_kernel_matches_plain_one_iteration(cuda, nb, structure):
    qp = _to(_qps(nb, structure=structure), cuda)
    before = solve_ocp_qp_fused.launches
    sol = solve_ocp_qp_fused(qp, iters=1, structure=structure)
    torch.cuda.synchronize()
    assert solve_ocp_qp_fused.launches == before + 1
    ref = solve_ocp_qp_fused_ref(qp, iters=1)
    for f in ("dx", "du", "s"):
        torch.testing.assert_close(getattr(sol, f), getattr(ref, f), rtol=0, atol=5e-4)
    torch.testing.assert_close(sol.mu, ref.mu, rtol=1e-5, atol=0)


@STRUCTURES
def test_kernel_tracks_f64_like_plain_converged(cuda, structure):
    """After 25 f32 iterations at N=20, M=5 the kernel and the plain version
    differ by up to ~4e-3 on a few elements (association order amplified by
    the centering power), so both are judged against the converged float64
    plain solve by the rule of scripts/tpu_equiv_check.py."""
    # one row of the unicycle-structured QPs needs 30 iterations to reach
    # mu < 1e-6, in the plain version too (2.7e-6 after 25)
    iters = 25 if structure == GENERIC_STRUCTURE else 30
    qp = _to(_qps(256, seed=1, structure=structure), cuda)
    sol = solve_ocp_qp_fused(qp, iters=iters, structure=structure)
    ref = solve_ocp_qp_fused_ref(qp, iters=iters)
    truth = solve_ocp_qp_fused_ref(OcpQp(*[a.double() for a in qp]), iters=80)
    assert float(sol.mu.max()) < 1e-6
    q = torch.tensor([0.5, 0.95], dtype=torch.float64, device=cuda)
    for f in ("dx", "du"):
        want = getattr(truth, f)
        e_k = (getattr(sol, f).double() - want).abs().flatten(1).amax(1)
        e_p = (getattr(ref, f).double() - want).abs().flatten(1).amax(1)
        (mk, pk), (mp, pp) = torch.quantile(e_k, q).tolist(), torch.quantile(e_p, q).tolist()
        assert mk <= max(2 * mp, 1e-3) and pk <= max(2 * pp, 1e-2), (f, mk, pk, mp, pp)


@STRUCTURES
def test_kernel_hard_qps_stay_finite(cuda, structure):
    """The fixture's QPs come from the controller, so both instantiations apply."""
    d = np.load(FIXTURE)
    qp = OcpQp(*[torch.as_tensor(d[f], device=cuda) for f in OcpQp._fields])
    sol = solve_ocp_qp_fused(qp, iters=int(d["iters"]), structure=structure)
    for a in sol:
        assert torch.isfinite(a).all()


@STRUCTURES
def test_kernel_long_horizon_matches_plain(cuda, structure):
    """N=40, M=8: about 29 KB of shared memory per scenario, still on chip
    and one launch."""
    qp = _to(_qps(64, N=40, M=8, seed=2, structure=structure), cuda)
    assert ip_fused.plan(64, 40, 8, structure).work == 0
    before = solve_ocp_qp_fused.launches
    sol = solve_ocp_qp_fused(qp, iters=1, structure=structure)
    torch.cuda.synchronize()
    assert solve_ocp_qp_fused.launches == before + 1
    ref = solve_ocp_qp_fused_ref(qp, iters=1)
    for f in ("dx", "du", "s"):
        torch.testing.assert_close(getattr(sol, f), getattr(ref, f), rtol=0, atol=5e-4)


@STRUCTURES
@pytest.mark.parametrize("N", [200, 400])
def test_kernel_past_shared_memory_runs_from_device_memory(cuda, structure, N):
    """Past the horizon at which a block's shared memory holds two
    scenarios (about N=180 at M=5), the same kernel keeps their arrays in a
    device-memory workspace: one launch, and the plain version's answer."""
    nb = 16
    qp = _to(_qps(nb, N=N, M=5, seed=3, structure=structure), cuda)
    assert ip_fused.smem_bytes(N, 5, structure) > 232448
    assert ip_fused.plan(nb, N, 5, structure).work > 0
    before = solve_ocp_qp_fused.launches
    sol = solve_ocp_qp_fused(qp, iters=1, structure=structure)
    torch.cuda.synchronize()
    assert solve_ocp_qp_fused.launches == before + 1
    ref = solve_ocp_qp_fused_ref(qp, iters=1)
    for f in ("dx", "du", "s"):
        want = getattr(ref, f)     # 5e-4 of the output's scale: long rollouts grow
        torch.testing.assert_close(getattr(sol, f), want, rtol=0,
                                   atol=5e-4 * max(1.0, float(want.abs().max())))


def test_kernel_raises_when_shared_memory_does_not_fit(cuda, monkeypatch):
    """A launch whose arrays exceed a block's shared memory, given no
    workspace, is refused and raises; nothing runs and nothing is counted."""
    N = 2000
    assert ip_fused.smem_bytes(N, 5) > 232448
    pl = ip_fused.plan(2, N, 5)
    monkeypatch.setattr(ip_fused, "_plan", lambda *a: pl._replace(
        bytes=ip_fused.smem_bytes(N, 5), work=0))
    qp = _to(_qps(2, N=N), cuda)
    before = solve_ocp_qp_fused.launches
    with pytest.raises(RuntimeError, match="shared memory"):
        solve_ocp_qp_fused(qp, iters=1)
    assert solve_ocp_qp_fused.launches == before


def test_kernel_plans_once_per_shape(cuda, monkeypatch):
    """The launch plan (grid, shared memory, workspace) is made on the first
    launch of a card, structure, batch and shape: a second launch of the
    same shape calls ``ip_solve_plan`` zero times. A plan for a larger
    horizon (more shared memory) does not break the launches of a smaller
    one, which give the bits they gave before it."""
    lib, planned = ip_fused._library(), []

    class Spy:
        def __getattr__(self, name):
            planned.extend([name] if name == "ip_solve_plan" else [])
            return getattr(lib, name)

    monkeypatch.setattr(ip_fused, "_library", lambda: Spy())
    ip_fused._plan.cache_clear()
    uni = UNICYCLE_QP_STRUCTURE
    small, large = (_to(_qps(37, N=N, M=M, seed=7, structure=uni), cuda)
                    for N, M in ((20, 5), (40, 8)))
    first = solve_ocp_qp_fused(small, iters=10, structure=uni)
    assert len(planned) == 1
    again = solve_ocp_qp_fused(small, iters=10, structure=uni)
    assert len(planned) == 1
    solve_ocp_qp_fused(large, iters=10, structure=uni)
    last = solve_ocp_qp_fused(small, iters=10, structure=uni)
    assert len(planned) == 2
    for a, b, c in zip(first, again, last):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_kernel_rejects_what_it_does_not_take(cuda):
    qp = _to(_qps(4), cuda)
    before = solve_ocp_qp_fused.launches
    with pytest.raises(TypeError, match="float32"):
        solve_ocp_qp_fused(OcpQp(*[a.double() for a in qp]), iters=1)
    with pytest.raises(ValueError, match="OcpQp.R"):
        solve_ocp_qp_fused(qp._replace(R=qp.R[:, :-1]), iters=1)
    with pytest.raises(ValueError, match="iters"):
        solve_ocp_qp_fused(qp, iters=0)
    assert solve_ocp_qp_fused.launches == before


def test_main_path_on_cuda_goes_through_the_kernel(cuda, monkeypatch):
    def plain_on_a_card(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")

    spec = WorldSpec(tf=2.0, n_solv=20, n_obst=5, qp_iter=6)
    opts = SolverOptions(qp_iter=6, integrator="rk4", compat_pred_bug=True)
    before = solve_ocp_qp_fused.launches
    with monkeypatch.context() as mp:
        mp.setattr(ip_fused, "solve_ocp_qp_fused_ref", plain_on_a_card)
        gpu = run_scenario_batch(spec, opts, "RANDOM", n_runs=8, max_iter=15,
                                 compat_rng=True, device=cuda)
    assert solve_ocp_qp_fused.launches == before + 15
    cpu = run_scenario_batch(spec, opts, "RANDOM", n_runs=8, max_iter=15,
                             compat_rng=True, device="cpu")
    assert np.isfinite(gpu).all()
    np.testing.assert_array_equal(gpu[:, [0, 1, 4, 5]], cpu[:, [0, 1, 4, 5]])
    np.testing.assert_allclose(gpu[:, [2, 3]], cpu[:, [2, 3]], rtol=0, atol=1e-2)


def _campaign_qps(cuda, nb, ticks=5):
    """One campaign tick's QPs (rk4, N=20, M=5, RANDOM rows after ``ticks``
    ticks at 100 IP iterations), float32 on the card."""
    spec = WorldSpec(tf=2.0, n_solv=20, n_obst=5, qp_iter=100)
    opts = SolverOptions(qp_iter=100, integrator="rk4")
    ctrl = make_rti_controller(spec, opts, dtype=torch.float32, device=cuda)
    params = default_cost_params(spec, dtype=torch.float32, device=cuda)
    start, goal = robot_start_goal(spec)
    gen = torch.Generator(device=cuda).manual_seed(0)
    st = init_loop_state(ctrl, start, goal, "RANDOM", batch_shape=(nb,), generator=gen)
    tick = make_batched_tick(ctrl, goal, params, backend="fused", generator=gen)
    for _ in range(ticks):
        st = tick(st)
    pred = predict_trajectory(st.obst, spec, spec.n_solv).movedim(0, 1)
    return ctrl.build_qp(st.rti, st.x0,
                         torch.as_tensor(goal, dtype=torch.float32, device=cuda), pred, params)


def _counted(qp, iters, structure):
    """A launch while a profiler records: its solution and the kept
    ``k1.iters`` and ``k1.end``, on the host."""
    profiling.clear_kept()
    with profile(activities=[ProfilerActivity.CPU]):
        sol = solve_ocp_qp_fused(qp, iters=iters, structure=structure)
    (used,), (end,) = profiling.kept("k1.iters"), profiling.kept("k1.end")
    profiling.clear_kept()
    return sol, used.long().cpu(), end.long().cpu()


def test_kernel_counts_the_iterations_its_plain_version_counts(cuda, monkeypatch):
    """K1's per-row iteration counts (written while a profiler records) on
    one campaign tick's QPs (rk4, B=256, N=20, M=5, 100 iterations, after 5
    ticks) against the plain version's in float32 on the CPU: equal on at
    least 95% of the rows and within 2 on the rest, since the two round
    differently and a row near the tolerances may meet them an iteration
    apart. With no profiler recording the kernel gets a null pointer and
    nothing is kept; the count changes none of its outputs."""
    qp = _campaign_qps(cuda, 256)
    lib, handed = ip_fused._library(), []

    class Spy:
        def __getattr__(self, name):
            return getattr(lib, name)

        def ip_solve_f32(self, *args):
            handed.append(args[-2])
            return lib.ip_solve_f32(*args)

    monkeypatch.setattr(ip_fused, "_library", lambda: Spy())
    profiling.clear_kept()
    plain_run = solve_ocp_qp_fused(qp, iters=100, structure=UNICYCLE_QP_STRUCTURE)
    assert handed == [None] and profiling.kept("k1.iters") == []
    with profile(activities=[ProfilerActivity.CPU]):
        counted_run = solve_ocp_qp_fused(qp, iters=100, structure=UNICYCLE_QP_STRUCTURE)
        ref = solve_ocp_qp_fused_ref(OcpQp(*[a.cpu() for a in qp]), iters=100,
                                     structure=UNICYCLE_QP_STRUCTURE)
    assert handed[1] is not None
    got, want = [k.long().cpu() for k in profiling.kept("k1.iters")]
    profiling.clear_kept()
    for a, b in zip(plain_run, counted_run):
        assert torch.equal(a, b)
    assert int(got.min()) >= 0 and int(got.max()) <= 100
    assert float((got == want).double().mean()) >= 0.95, (got, want)
    assert int((got - want).abs().max()) <= 2, (got, want)


def test_kernel_leaves_the_loop_once_a_row_is_frozen(cuda):
    """In one pass (one row per tile) a row's tile runs the iterations that
    updated the row and the one that froze it, and no more: ``end`` is
    min(used + 1, iters) on every row of a campaign tick at 100 iterations,
    where rows need different numbers of iterations."""
    qp = _campaign_qps(cuda, 256)
    _, used, end = _counted(qp, 100, UNICYCLE_QP_STRUCTURE)
    assert torch.equal(end, torch.clamp_max(used + 1, 100))
    assert int(end.min()) < int(end.max()), end


def _mixed_qps(cuda, nb, N, structure):
    """``nb`` random QPs with the fixture's hard rows in every 97th place
    (N=20, M=5 only)."""
    qp = _qps(nb, N=N, seed=4, structure=structure)
    if N == 20:
        d = np.load(FIXTURE)
        hard = OcpQp(*[torch.as_tensor(d[f]) for f in OcpQp._fields])
        at = torch.arange(0, nb, 97)
        qp = OcpQp(*[a.index_put((at,), h[torch.arange(len(at)) % h.shape[0]])
                     for a, h in zip(qp, hard)])
    return _to(qp, cuda)


@STRUCTURES
@pytest.mark.parametrize("N,iters", [(20, 100), (200, 10)], ids=["on_chip", "workspace"])
def test_kernel_rows_do_not_depend_on_the_hand_out(cuda, structure, N, iters):
    """At three times the tiles the card holds at once, tiles take their
    later rows from the launch's counter, in an order that depends on how
    long each row runs. Every output of every row is bit for bit the same
    when the rows are launched in a permuted order and when a sample of
    rows (the hard ones among them) is launched alone, from shared memory
    (N=20) and from the device-memory workspace (N=200)."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    tiles = sms * ip_fused.plan(1, N, 5, structure).resident
    nb = 3 * tiles
    qp = _mixed_qps(cuda, nb, N, structure)
    if N == 200:
        pl = ip_fused.plan(nb, N, 5, structure)
        assert pl.blocks * 2 == tiles and pl.bytes == 0
        assert pl.work == tiles * pl.per == tiles * (ip_fused.smem_bytes(N, 5, structure) // 8)
    sol, used, end = _counted(qp, iters, structure)
    run = torch.clamp_max(used + 1, iters)
    assert bool((end >= run).all()) and bool((end > run).any())   # tiles took more rows
    perm = torch.randperm(nb, generator=torch.Generator().manual_seed(0)).to(cuda)
    shuffled = solve_ocp_qp_fused(OcpQp(*[a[perm] for a in qp]), iters=iters,
                                  structure=structure)
    inv = torch.argsort(perm)
    for a, b in zip(sol, shuffled):
        assert torch.equal(a, b[inv])
    sample = sorted({0, 97, 194, 1, nb // 2, nb - 1, int(torch.argmax(used))})
    for b in sample:
        alone = solve_ocp_qp_fused(OcpQp(*[a[b:b + 1] for a in qp]), iters=iters,
                                   structure=structure)
        for x, y in zip(sol, alone):
            assert torch.equal(x[b:b + 1], y), b
    for a in sol:
        assert bool(torch.isfinite(a).all())


@STRUCTURES
@pytest.mark.parametrize("N,iters", [(20, 100), (200, 10)], ids=["on_chip", "workspace"])
def test_kernel_skips_the_masked_rows(cuda, structure, N, iters):
    """At three times the card's tiles, the hard rows mixed in and about
    half of the rows masked (hard rows on both sides): on the unmasked rows
    K1 gives every output and count bit for bit as without the mask, on the
    masked rows zeros and 0 iterations, and it counts the masked rows in
    ``k1.skipped``. A masked row's ``end`` is its tile's count before it:
    0 where it is its tile's first row, no more than the launch's length
    elsewhere. Without a profiler the mask gives the same outputs."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    tiles = sms * ip_fused.plan(1, N, 5, structure).resident
    nb = 3 * tiles
    qp = _mixed_qps(cuda, nb, N, structure)
    skip = torch.rand(nb, generator=torch.Generator().manual_seed(5)) < 0.5
    skip[::97] = torch.arange(0, nb, 97) % 194 == 0          # every other hard row
    skip = skip.to(cuda)
    want, want_used, _ = _counted(qp, iters, structure)
    profiling.clear_kept()
    with profile(activities=[ProfilerActivity.CPU]):
        sol = solve_ocp_qp_fused(qp, iters=iters, structure=structure, skip=skip)
    (used,), (end,), (skipped,) = (profiling.kept(k) for k in ("k1.iters", "k1.end",
                                                               "k1.skipped"))
    profiling.clear_kept()
    for f in sol._fields:
        got, ref = getattr(sol, f), getattr(want, f)
        if f == "kappa":
            assert torch.equal(got, ref)
            continue
        assert torch.equal(got[~skip], ref[~skip]), f
        assert bool((got[skip] == 0).all()), f
    skip, used, end = skip.cpu(), used.long().cpu(), end.long().cpu()
    assert 0.4 < float(skip.double().mean()) < 0.6
    assert torch.equal(used, torch.where(skip, 0, want_used))
    assert int(skipped.cpu()) == int(skip.sum())
    run = torch.clamp_max(used + 1, iters)
    assert bool((end[~skip] >= run[~skip]).all())
    first = torch.arange(nb) < tiles
    assert bool((end[skip & first] == 0).all())
    assert bool((end[skip] <= int(end.max())).all()) and bool((end >= 0).all())
    untraced = solve_ocp_qp_fused(qp, iters=iters, structure=structure, skip=skip.to(cuda))
    for a, b in zip(sol, untraced):
        assert torch.equal(a, b)


def _lqrs(nb, N=20, seed=0):
    """Seeded LQR batches with SPD costs (the recipe of
    tests/test_riccati._random_lqr, batched), float64, in the order of
    riccati_solve_fused's arguments."""
    rng = np.random.default_rng(seed)
    nx, nu = 5, 2
    G = rng.standard_normal((nb, N + 1, nx, nx))
    H = rng.standard_normal((nb, N, nu, nu))
    return [torch.tensor(a) for a in (
        G @ np.swapaxes(G, -1, -2) + 0.1 * np.eye(nx),              # Q
        H @ np.swapaxes(H, -1, -2) + 0.5 * np.eye(nu),              # R
        0.1 * rng.standard_normal((nb, N, nu, nx)),                 # S
        0.9 * np.eye(nx) + 0.1 * rng.standard_normal((nb, N, nx, nx)),   # A
        rng.standard_normal((nb, N, nx, nu)),                       # B
        rng.standard_normal((nb, N + 1, nx)),                       # q
        rng.standard_normal((nb, N, nu)),                           # r
        rng.standard_normal((nb, N, nx)),                           # d
        rng.standard_normal((nb, nx)))]                             # x0


def _riccati_matches_plain(args64):
    """f64: the kernel equals its plain version to 1e-9 relative. f32: it is
    no further from the f64 plain output than the plain f32 version is
    (2x margin; the two sum in different orders)."""
    before = riccati_solve_fused.launches
    got64 = riccati_solve_fused(*args64)
    torch.cuda.synchronize()
    assert riccati_solve_fused.launches == before + 1
    ref64 = riccati_solve_fused_ref(*args64)
    for g, w in zip(got64, ref64):
        assert g.dtype == torch.float64
        scale = max(1.0, float(w.abs().max()))
        assert float((g - w).abs().max()) <= 1e-9 * scale
    args32 = [a.float() for a in args64]
    got32 = riccati_solve_fused(*args32)
    ref32 = riccati_solve_fused_ref(*args32)
    for g, p, w in zip(got32, ref32, ref64):
        assert g.dtype == torch.float32 and bool(torch.isfinite(g).all())
        e_k = float((g.double() - w).abs().max())
        e_p = float((p.double() - w).abs().max())
        assert e_k <= 2 * e_p + 1e-6 * max(1.0, float(w.abs().max())), (e_k, e_p)


@pytest.mark.parametrize("N", [1, 2, 3, 20])     # 2, 3: fewer stages than the ring holds
@pytest.mark.parametrize("nb", [1, 37, 512, 4096])
def test_riccati_kernel_matches_plain(cuda, nb, N):
    args = [a.to(cuda) for a in _lqrs(nb, N=N)]
    assert riccati_fused.plan(nb, N, torch.float64).work == 0
    _riccati_matches_plain(args)


def test_riccati_kernel_past_shared_memory_runs_from_device_memory(cuda):
    """Past the horizon at which a block's shared memory holds its
    scenarios' scratch (N=682 in f32, 336 in f64 at a team of 16), the same
    body keeps the scratch in a device-memory workspace: one launch per
    dtype, and the plain version's answer in f64 and f32."""
    N, nb = 800, 37
    for dtype in (torch.float32, torch.float64):
        assert riccati_fused.smem_bytes(N, dtype) > 232448
        assert riccati_fused.plan(nb, N, dtype).work > 0
    _riccati_matches_plain([a.to(cuda) for a in _lqrs(nb, N=N, seed=4)])


def test_riccati_kernel_refuses_non_contiguous_input(cuda):
    """The kernel reads each scenario's field as one run: a strided view
    raises before any launch and is not counted."""
    args = [a.to(cuda) for a in _lqrs(4, N=3)]
    before = riccati_solve_fused.launches
    for i in (0, 3, 8):
        bad = list(args)
        bad[i] = args[i].mT.contiguous().mT if args[i].ndim > 2 else args[i].t().contiguous().t()
        assert not bad[i].is_contiguous()
        with pytest.raises(ValueError, match="not contiguous"):
            riccati_solve_fused(*bad)
    assert riccati_solve_fused.launches == before


def test_riccati_kernel_plans_once_per_shape(cuda):
    """The launch plan (grid, shared memory, workspace) is made on the first
    call of a device, dtype, batch and horizon and reused after; a plan for a
    larger horizon does not break the launches of a smaller one."""
    riccati_fused._plan.cache_clear()
    small, large = ([a.to(cuda) for a in _lqrs(37, N=N, seed=5)] for N in (3, 40))
    for args in (large, small, large, small):
        riccati_solve_fused(*args)
    torch.cuda.synchronize()
    info = riccati_fused._plan.cache_info()
    assert (info.misses, info.hits) == (2, 2)
    _riccati_matches_plain(small)


def test_riccati_backend_launches_k2_and_never_its_plain_version(cuda, monkeypatch):
    def plain_on_a_card(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(riccati_fused, "riccati_solve_fused_ref", plain_on_a_card)
    qp = _to(_qps(256), cuda)
    before = riccati_solve_fused.launches
    sol = solve_ocp_qp(qp, iters=3, backend="riccati")
    torch.cuda.synchronize()
    assert riccati_solve_fused.launches == before + 2 * 3
    ref = solve_ocp_qp(qp, iters=3, backend="torch")
    assert riccati_solve_fused.launches == before + 2 * 3
    for f in ("dx", "du", "s"):
        torch.testing.assert_close(getattr(sol, f), getattr(ref, f), rtol=0, atol=5e-4)


def test_riccati_kernel_rejects_what_it_does_not_take(cuda):
    args = [a.to(cuda) for a in _lqrs(4, N=3)]
    before = riccati_solve_fused.launches
    with pytest.raises(TypeError, match="float32 or float64"):
        riccati_solve_fused(*[a.half() for a in args])
    with pytest.raises(TypeError, match="is torch.float32"):
        riccati_solve_fused(*args[:5], args[5].float(), *args[6:])
    with pytest.raises(ValueError, match="is on cpu"):
        riccati_solve_fused(*args[:8], args[8].cpu())
    with pytest.raises(ValueError, match="nx=5"):
        riccati_solve_fused(*[a[..., :4] if a.shape[-1] == 5 else a for a in args])
    assert riccati_solve_fused.launches == before


def test_main_path_riccati_on_cuda_goes_through_k2(cuda):
    spec = WorldSpec(tf=2.0, n_solv=20, n_obst=5, qp_iter=6)
    opts = SolverOptions(qp_iter=6, integrator="rk4", compat_pred_bug=True)
    before = riccati_solve_fused.launches
    gpu = run_scenario_batch(spec, opts, "RANDOM", n_runs=8, max_iter=10,
                             compat_rng=True, backend="riccati", device=cuda)
    assert riccati_solve_fused.launches == before + 10 * 6 * 2
    cpu = run_scenario_batch(spec, opts, "RANDOM", n_runs=8, max_iter=10,
                             compat_rng=True, backend="riccati", device="cpu")
    assert np.isfinite(gpu).all()
    np.testing.assert_array_equal(gpu[:, [0, 1, 4, 5]], cpu[:, [0, 1, 4, 5]])
    np.testing.assert_allclose(gpu[:, [2, 3]], cpu[:, [2, 3]], rtol=0, atol=1e-2)


@STRUCTURES
def test_kernel_sweep_corner_matches_plain(cuda, structure):
    """N=30, M=30 (the widest corner of the horizon sweep), B=100: one
    launch, the plain version's answer after 1 iteration."""
    qp = _to(_qps(100, N=30, M=30, seed=5, structure=structure), cuda)
    assert ip_fused.plan(100, 30, 30, structure).work == 0
    before = solve_ocp_qp_fused.launches
    sol = solve_ocp_qp_fused(qp, iters=1, structure=structure)
    torch.cuda.synchronize()
    assert solve_ocp_qp_fused.launches == before + 1
    ref = solve_ocp_qp_fused_ref(qp, iters=1)
    for f in ("dx", "du", "s"):
        torch.testing.assert_close(getattr(sol, f), getattr(ref, f), rtol=0, atol=5e-4)


@STRUCTURES
@pytest.mark.parametrize("iters", [100, 150])
def test_kernel_sweep_budgets_pass_f64_arbitration(cuda, structure, iters):
    """The sweeps' largest IP budgets at N=30, M=30: the kernel's du is no
    further from the converged float64 solve than the rule of chip_smoke.py
    phase 3 allows against the plain f32 version (median <= max(2x plain,
    1e-3), p95 <= max(2x plain, 1e-2))."""
    qp = _to(_qps(100, N=30, M=30, seed=6, structure=structure), cuda)
    truth = solve_ocp_qp_fused_ref(OcpQp(*[a.double() for a in qp]), iters=200).du
    q = torch.tensor([0.5, 0.95], dtype=torch.float64, device=cuda)
    e_k = (solve_ocp_qp_fused(qp, iters=iters, structure=structure).du.double()
           - truth).abs().amax((1, 2))
    e_p = (solve_ocp_qp_fused_ref(qp, iters=iters).du.double() - truth).abs().amax((1, 2))
    (mk, pk), (mp, pp) = torch.quantile(e_k, q).tolist(), torch.quantile(e_p, q).tolist()
    assert mk <= max(2 * mp, 1e-3) and pk <= max(2 * pp, 1e-2), (mk, pk, mp, pp)


def test_irk_fused_tick_on_cuda_goes_through_the_kernel(cuda, monkeypatch):
    """With the default integrator (IRK) the fused main path launches K1
    once per tick and K3 twice, and never hands a CUDA tensor to a plain
    version."""
    def plain_on_a_card(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")

    spec = WorldSpec(tf=2.0, n_solv=20, n_obst=5, qp_iter=50)
    opts = SolverOptions(qp_iter=50, compat_pred_bug=True)
    assert opts.integrator == "irk"
    before, k3 = solve_ocp_qp_fused.launches, integrators.irk_step_fused.launches
    with monkeypatch.context() as mp:
        mp.setattr(ip_fused, "solve_ocp_qp_fused_ref", plain_on_a_card)
        for name in ("irk_step_ref", "_irk_substep", "irk_newton_solve_ref"):
            mp.setattr(integrators, name, plain_on_a_card)
        gpu = run_scenario_batch(spec, opts, "RANDOM", n_runs=8, max_iter=12,
                                 compat_rng=True, device=cuda)
    assert solve_ocp_qp_fused.launches == before + 12
    # K3: the linearization's step (with the sensitivities) and the plant
    # step, per tick
    assert integrators.irk_step_fused.launches == k3 + 2 * 12
    cpu = run_scenario_batch(spec, opts, "RANDOM", n_runs=8, max_iter=12,
                             compat_rng=True, device="cpu")
    assert np.isfinite(gpu).all()
    np.testing.assert_array_equal(gpu[:, [0, 1, 4, 5]], cpu[:, [0, 1, 4, 5]])
    np.testing.assert_allclose(gpu[:, [2, 3]], cpu[:, [2, 3]], rtol=0, atol=1e-2)


def test_batched_tick_on_cuda_never_waits_for_the_device(cuda):
    """The campaign tick of 100 RANDOM + 100 EDGE rows (IRK, fused, 100 IP
    iterations) makes no host copy and no other call that waits for the
    device: ten ticks run under ``set_sync_debug_mode("error")``, which
    raises at the first such call. So the host can enqueue the next tick
    while K1 runs."""
    spec = WorldSpec(tf=2.0, n_solv=20, n_obst=5, qp_iter=100)
    opts = SolverOptions(qp_iter=100, compat_pred_bug=True)
    assert opts.integrator == "irk"
    ctrl = make_rti_controller(spec, opts, dtype=torch.float32, device=cuda)
    params = default_cost_params(spec, dtype=torch.float32, device=cuda)
    start, goal = robot_start_goal(spec)
    gen = torch.Generator(device=cuda).manual_seed(0)
    worlds = [generate_obstacles(gen, spec, s, (100,), device=cuda) for s in ("RANDOM", "EDGE")]
    obst = ObstacleState(*(torch.cat(a) for a in zip(*worlds)))
    st = init_loop_state(ctrl, start, goal, batch_shape=(200,), obst=obst)
    tick = make_batched_tick(ctrl, goal, params, backend="fused")

    def noise():
        return torch.randn((200, spec.n_obst, 2), generator=gen, device=cuda)

    for _ in range(2):
        st = tick(st, noise())
    torch.cuda.synchronize()
    before = solve_ocp_qp_fused.launches
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(10):
            st = tick(st, noise())
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    assert solve_ocp_qp_fused.launches == before + 10
    assert bool(torch.isfinite(st.x0).all())


def test_status4_fused_irk_on_cuda_fires_and_goes_through_the_kernel(cuda, monkeypatch):
    """The status-4 analogue with the plant brake (the parity legs v0 and
    v2) on the fused IRK path: 6 IP iterations miss the fail tolerances, so
    rows reset and brake; one K1 launch per tick, finite rows."""
    def plain_on_a_card(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")

    spec = WorldSpec(tf=2.0, n_solv=20, n_obst=5, qp_iter=6)
    opts = SolverOptions(qp_iter=6, compat_pred_bug=True, init_guess_when_error=True,
                         compat_brake_bug=True)
    before = solve_ocp_qp_fused.launches
    with monkeypatch.context() as mp:
        mp.setattr(ip_fused, "solve_ocp_qp_fused_ref", plain_on_a_card)
        rows, final = run_scenario_batch(spec, opts, "RANDOM", n_runs=8, max_iter=20,
                                         compat_rng=True, return_state=True, device=cuda)
    assert solve_ocp_qp_fused.launches == before + 20
    assert np.isfinite(rows).all() and rows.shape == (8, 6)
    assert int(final.resets.sum()) > 0


def test_f64_riccati_irk_tick_on_cuda_launches_k2_f64(cuda, monkeypatch):
    """The f64 IRK closed loop through the riccati backend (the parity leg
    f64_nostatus4 on the card): two launches of K2's f64 entry point per IP
    iteration, no plain Riccati solve, and the CPU's rows."""
    spec = WorldSpec(tf=2.0, n_solv=20, n_obst=5, qp_iter=10)
    opts = SolverOptions(qp_iter=10, compat_pred_bug=True)
    kw = dict(n_runs=4, max_iter=2, dtype=torch.float64, backend="riccati", compat_rng=True)
    before = riccati_solve_fused.launches
    with monkeypatch.context() as mp:
        _forbid_plain_riccati(mp)
        gpu, fin = run_scenario_batch(spec, opts, "RANDOM", return_state=True, device=cuda, **kw)
    assert riccati_solve_fused.launches == before + 2 * opts.qp_iter * 2
    assert fin.x0.dtype == torch.float64
    cpu, fin_cpu = run_scenario_batch(spec, opts, "RANDOM", return_state=True, device="cpu", **kw)
    np.testing.assert_array_equal(gpu[:, [0, 1, 4, 5]], cpu[:, [0, 1, 4, 5]])
    np.testing.assert_allclose(fin.x0.cpu().numpy(), fin_cpu.x0.numpy(), rtol=0, atol=1e-7)


def test_irk_step_on_cuda_f32_within_1e5_of_cpu_f64(cuda):
    """The f32 step through K3 on the card (TF32 off) lands within 1e-5 of
    the float64 step on the CPU, and so do the sensitivities of the
    controller's linearization."""
    from doa_mpc_tpu_torch.models.unicycle import dynamics
    from doa_mpc_tpu_torch.ops.integrators import irk_step
    from doa_mpc_tpu_torch.solver.sqp_rti import make_rti_controller

    assert torch.backends.cuda.matmul.allow_tf32 is False
    rng = np.random.default_rng(7)
    x = rng.standard_normal((4096, 5)) * np.array([3, 3, 1, 2, 1])
    u = rng.standard_normal((4096, 2)) * 3
    got = irk_step(dynamics, torch.tensor(x, dtype=torch.float32, device=cuda),
                   torch.tensor(u, dtype=torch.float32, device=cuda), 0.1)
    want = irk_step(dynamics, torch.tensor(x), torch.tensor(u), 0.1)
    np.testing.assert_allclose(got.double().cpu().numpy(), want.numpy(), rtol=0, atol=1e-5)
    spec = WorldSpec()
    xs, us = x[:4000].reshape(200, 20, 5), u[:4000].reshape(200, 20, 2)
    lin32 = make_rti_controller(spec, dtype=torch.float32, device=cuda).lin(
        torch.tensor(xs, dtype=torch.float32, device=cuda),
        torch.tensor(us, dtype=torch.float32, device=cuda))
    lin64 = make_rti_controller(spec, dtype=torch.float64, device="cpu").lin(
        torch.tensor(xs), torch.tensor(us))
    for g, w in zip(lin32, lin64):
        np.testing.assert_allclose(g.double().cpu().numpy(), w.numpy(), rtol=0, atol=1e-5)


def _k3_inputs(dev, dtype, rows, seed=0, kind="gauss_legendre", stages=4):
    """States and controls like the controller's (N(0, s) per coordinate),
    and a tableau, as K3 takes them."""
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.standard_normal((rows, 5)) * np.array([3, 3, 1, 2, 1]), dtype=dtype,
                     device=dev)
    u = torch.tensor(rng.standard_normal((rows, 2)), dtype=dtype, device=dev)
    A, b = integrators._tableau_tensors(kind, stages, dtype, dev)
    return x, u, A, b


@pytest.mark.parametrize("sens", [False, True], ids=["phi", "sens"])
@pytest.mark.parametrize("rows", [1, 37, 4096, 81920])
def test_k3_matches_plain(cuda, rows, sens):
    """K3 against its plain version (``irk_step_ref``) on the card, 4-stage
    Gauss-Legendre, 3 Newton iterations: f64 to 1e-12 relative; f32 no
    further from the f64 plain output than 2x the plain f32 version (and
    1e-6)."""
    x, u, A, b = _k3_inputs(cuda, torch.float64, rows)
    before = integrators.irk_step_fused.launches
    got = integrators.irk_step_fused(x, u, A, b, 0.1, 3, 1, sens)
    want = integrators.irk_step_ref(x, u, A, b, 0.1, 3, 1, sens)
    torch.cuda.synchronize()
    assert integrators.irk_step_fused.launches == before + 1
    got, want = (got, want) if sens else ((got,), (want,))
    x32, u32, A32, b32 = (t.float() for t in (x, u, A, b))
    got32 = integrators.irk_step_fused(x32, u32, A32, b32, 0.1, 3, 1, sens)
    plain32 = integrators.irk_step_ref(x32, u32, A32, b32, 0.1, 3, 1, sens)
    got32, plain32 = (got32, plain32) if sens else ((got32,), (plain32,))
    for g, w, g32, p32 in zip(got, want, got32, plain32):
        assert g.shape == w.shape and g.dtype == torch.float64 and g32.dtype == torch.float32
        scale = max(1.0, float(w.abs().max()))
        assert float((g - w).abs().max()) / scale <= 1e-12
        e_k = float((g32.double() - w).abs().max())
        e_p = float((p32.double() - w).abs().max())
        assert np.isfinite(e_k) and e_k <= max(2 * e_p, 1e-6), (e_k, e_p)


@pytest.mark.parametrize("kind,stages,newton_iter,num_steps",
                         [("gauss_legendre", 1, 1, 2), ("gauss_legendre", 2, 3, 1),
                          ("gauss_legendre", 3, 2, 2), ("radau_iia", 3, 3, 2)])
def test_k3_other_instantiations_match_plain(cuda, kind, stages, newton_iter, num_steps):
    """The other stage counts, Newton iteration counts and substeps (the
    ``sim`` command's Radau IIA with 3 stages among them), f64 with the
    sensitivities, to 1e-12 relative."""
    x, u, A, b = _k3_inputs(cuda, torch.float64, 300, seed=2, kind=kind, stages=stages)
    h = 0.1 / num_steps
    got = integrators.irk_step_fused(x, u, A, b, h, newton_iter, num_steps, True)
    want = integrators.irk_step_ref(x, u, A, b, h, newton_iter, num_steps, True)
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) / max(1.0, float(w.abs().max())) <= 1e-12


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k3_rows_do_not_depend_on_the_batch(cuda, dtype):
    """The first rows give the same bits alone as inside a batch of 81,920,
    and so do rows at the end of the batch, with and without D."""
    x, u, A, b = _k3_inputs(cuda, dtype, 81920, seed=1)
    for sens in (True, False):
        whole = integrators.irk_step_fused(x, u, A, b, 0.1, 3, 1, sens)
        whole = whole if sens else (whole,)
        for sl in (slice(0, 1), slice(0, 100), slice(81900, 81920)):
            part = integrators.irk_step_fused(x[sl].clone(), u[sl].clone(), A, b, 0.1, 3, 1,
                                              sens)
            for p, w in zip(part if sens else (part,), whole):
                assert torch.equal(p, w[sl])


def test_k3_rejects_what_it_does_not_take(cuda):
    """Another dynamics, dtype, width or stage count, or mixed devices
    raise in ``irk_step`` and in the kernel's wrapper before a launch;
    there is no fallback to the plain version."""
    from doa_mpc_tpu_torch.models.unicycle import dynamics
    from doa_mpc_tpu_torch.ops.integrators import irk_step

    x, u, A, b = _k3_inputs(cuda, torch.float32, 8)
    before = integrators.irk_step_fused.launches
    with pytest.raises(ValueError, match="unicycle.dynamics only"):
        irk_step(lambda s_, c: dynamics(s_, c), x, u, 0.1)
    with pytest.raises(TypeError, match="float32 or float64"):
        irk_step(dynamics, x.half(), u.half(), 0.1)
    with pytest.raises(TypeError, match="u is"):
        irk_step(dynamics, x, u.double(), 0.1)
    with pytest.raises(ValueError, match="u is on"):
        irk_step(dynamics, x, u.cpu(), 0.1)
    with pytest.raises(ValueError, match="nx = 5 and nu = 2"):
        irk_step(dynamics, torch.zeros(8, 6, device=cuda), u, 0.1)
    with pytest.raises(ValueError, match="s in"):
        irk_step(dynamics, x, u, 0.1, stages=5)
    with pytest.raises(ValueError, match="A is on"):
        integrators.irk_step_fused(x, u, A.cpu(), b, 0.1, 3, 1, False)
    with pytest.raises(ValueError, match="need"):
        integrators.irk_step_fused(x, u, A, b, 0.1, 3, 0, False)
    assert integrators.irk_step_fused.launches == before


def test_k3_takes_the_sim_commands_unbatched_state(cuda):
    """The ``sim`` command's x (5,) and u (2,) with no leading dimension:
    one launch, the CPU's step (f32, 3-stage Radau IIA)."""
    from doa_mpc_tpu_torch.models.unicycle import dynamics
    from doa_mpc_tpu_torch.ops.integrators import irk_step

    x = torch.tensor([0.0, 0.0, np.pi / 4, 0.5, 0.1])
    u = torch.tensor([1.0, 0.5])
    before = integrators.irk_step_fused.launches
    got = irk_step(dynamics, x.to(cuda), u.to(cuda), 0.1, stages=3, tableau="radau_iia")
    assert integrators.irk_step_fused.launches == before + 1 and got.shape == (5,)
    want = irk_step(dynamics, x, u, 0.1, stages=3, tableau="radau_iia")
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0, atol=1e-6)


def test_irk_paired_rows_equal_rows_alone_on_cuda(cuda):
    """IRK rows on the card do not depend on the batch: an EDGE cell's rows
    run alone equal its rows run behind the RANDOM cell's (compat_rng, f32,
    fused, 30 ticks)."""
    spec = WorldSpec(tf=2.0, n_solv=20, n_obst=5, qp_iter=20)
    opts = SolverOptions(qp_iter=20, compat_pred_bug=True)
    kw = dict(n_runs=16, max_iter=30, compat_rng=True, device=cuda, return_state=True)
    paired, fin_p = run_scenario_batch(spec, opts, ["RANDOM", "EDGE"], **kw)
    alone, fin_a = run_scenario_batch(spec, opts, "EDGE", **kw)
    np.testing.assert_array_equal(paired[16:], alone)
    assert torch.equal(fin_p.x0[16:], fin_a.x0)


# ---------------------------------------------------------------------------
# the single-scenario path, the RL layer and demo: K2 through rti_step
# ---------------------------------------------------------------------------

def _forbid_plain_riccati(mp):
    """K2's plain version and the plain Riccati sweep raise if reached."""
    from doa_mpc_tpu_torch.ops import ip_qp

    def plain_on_a_card(*a, **k):
        raise AssertionError("a CUDA tensor reached a plain Riccati solve")

    mp.setattr(riccati_fused, "riccati_solve_fused_ref", plain_on_a_card)
    mp.setattr(ip_qp, "riccati_factorize", plain_on_a_card)
    mp.setattr(ip_qp, "riccati_solve", plain_on_a_card)


def _rti_inputs(dev, dtype, nb, qp_iter=10):
    """A controller on ``dev`` and cold-start rti_step inputs of the RL
    env's shape (N=20, M=5, 10 IP iterations) on compat_rng worlds, one goal
    per row."""
    from doa_mpc_tpu_torch.config import default_cost_params
    from doa_mpc_tpu_torch.sim.closed_loop import init_loop_state
    from doa_mpc_tpu_torch.sim.compat_rng import mt_experiment_batch
    from doa_mpc_tpu_torch.sim.obstacles import predict_trajectory, robot_start_goal
    from doa_mpc_tpu_torch.solver.sqp_rti import make_rti_controller

    spec = WorldSpec(tf=2.0, n_solv=20, n_obst=5, qp_iter=qp_iter)
    ctrl = make_rti_controller(spec, SolverOptions(qp_iter=qp_iter, integrator="rk4"),
                               dtype=dtype, device=dev)
    start, goal = robot_start_goal(spec)
    obst, _ = mt_experiment_batch(range(nb), spec, "RANDOM", max_iter=1, dtype=np.float64)
    st = init_loop_state(ctrl, start, goal, batch_shape=(nb,), obst=obst)
    goals = torch.tensor(np.stack([np.linspace(-6.0, 6.0, nb), np.linspace(6.0, -3.0, nb)], -1),
                         dtype=dtype, device=dev)
    pred = predict_trajectory(st.obst, spec, spec.n_solv).movedim(0, 1)
    return ctrl, (st.rti, st.x0, goals, pred, default_cost_params(spec, dtype=dtype, device=dev))


def test_rti_step_on_cuda_launches_k2_and_matches_cpu(cuda, monkeypatch):
    """``rti_step`` on CUDA tensors launches K2 twice per IP iteration and
    never a plain Riccati solve. In f64 it matches the CPU's plain path at
    1e-10 (B=8: rows whose unconverged 10-iteration solve is well
    conditioned, which the CPU's two f64 solvers, K2's plain version and
    the plain Riccati sweep, confirm by agreeing at 1e-10; on some cold
    starts the iterates amplify last-bit differences to 1e-3). In f32 (B=64)
    it is no further from a converged f64 oracle than the CPU's f32 plain
    path allows (the rule of chip_smoke.py phase 3)."""
    from doa_mpc_tpu_torch.ops.ip_qp import solve_ocp_qp

    ctrl_cpu, args_cpu = _rti_inputs("cpu", torch.float64, 8)
    qp = ctrl_cpu.build_qp(*args_cpu)
    spread = (solve_ocp_qp(qp, iters=10, reg=1e-9, backend="riccati").du
              - solve_ocp_qp(qp, iters=10, reg=1e-9, backend="torch").du).abs().max()
    assert float(spread) < 1e-10
    new_cpu, u0_cpu, _ = ctrl_cpu.rti_step(*args_cpu)
    ctrl, args = _rti_inputs(cuda, torch.float64, 8)
    ctrl32, args32 = _rti_inputs(cuda, torch.float32, 64)
    before = riccati_solve_fused.launches
    with monkeypatch.context() as mp:
        _forbid_plain_riccati(mp)
        new, u0, _ = ctrl.rti_step(*args)
        u32 = ctrl32.rti_step(*args32)[1]
        torch.cuda.synchronize()
    assert riccati_solve_fused.launches == before + 2 * 2 * 10
    for g, w in ((new.x_traj, new_cpu.x_traj), (new.u_traj, new_cpu.u_traj), (u0, u0_cpu)):
        np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), rtol=0, atol=1e-10)
    c80, a80 = _rti_inputs("cpu", torch.float64, 64, qp_iter=80)
    truth = c80.rti_step(*a80)[1]
    c32, a32 = _rti_inputs("cpu", torch.float32, 64)
    u32_cpu = c32.rti_step(*a32)[1]
    e_k = (u32.double().cpu() - truth).abs().amax(1)
    e_p = (u32_cpu.double() - truth).abs().amax(1)
    q = torch.tensor([0.5, 0.95], dtype=torch.float64)
    (mk, pk), (mp_, pp) = torch.quantile(e_k, q).tolist(), torch.quantile(e_p, q).tolist()
    assert mk <= max(2 * mp_, 1e-3) and pk <= max(2 * pp, 1e-2), (mk, pk, mp_, pp)


def test_subgoal_env_step_on_cuda_is_finite(cuda, monkeypatch):
    from doa_mpc_tpu_torch.rl.env import SubgoalEnv

    env = SubgoalEnv(device=cuda)
    assert env.batch == 64 and env.k_ticks == 10
    st, obs = env.reset(torch.Generator(device=cuda).manual_seed(0))
    before = riccati_solve_fused.launches
    with monkeypatch.context() as mp:
        _forbid_plain_riccati(mp)
        st, obs, r, done = env.step(st, torch.full((64, 2), 6.0, device=cuda))
        torch.cuda.synchronize()
    assert riccati_solve_fused.launches == before + 2 * 10 * 10
    assert obs.shape == (64, env.obs_dim) and obs.is_cuda
    for a in (obs, r, st.loop.x0):
        assert bool(torch.isfinite(a).all())


def test_ddpg_update_on_cuda_with_a_cuda_generator(cuda):
    from doa_mpc_tpu_torch.rl.ddpg import DDPG, DDPGConfig, ReplayBuffer, Transition

    cfg = DDPGConfig()
    gen = torch.Generator(device=cuda).manual_seed(0)
    agent = DDPG(cfg, device=cuda).init(gen)
    buf = ReplayBuffer.create(cfg, device=cuda)
    obs = torch.randn((64, cfg.obs_dim), generator=gen, device=cuda)
    act = agent.act(obs, gen, noise=True)
    assert act.is_cuda and float(act.abs().max()) <= cfg.act_limit
    buf.add_batch(Transition(obs, act, torch.randn((64,), generator=gen, device=cuda),
                             obs.flip(0), torch.zeros((64,), device=cuda)))
    info = agent.update(buf.sample(gen, cfg.batch_size))
    assert info["critic_loss"].is_cuda and info["actor_loss"].is_cuda
    assert np.isfinite(float(info["critic_loss"])) and np.isfinite(float(info["actor_loss"]))


def test_demo_rollout_on_cuda_goes_through_k2(cuda, monkeypatch):
    from doa_mpc_tpu_torch import cli

    args = cli.build_parser().parse_args(["demo", "--device", "cuda", "--max-iter", "5"])
    k1, k2 = solve_ocp_qp_fused.launches, riccati_solve_fused.launches
    with monkeypatch.context() as mp:
        _forbid_plain_riccati(mp)
        _, _, _, fin, (xs, obs, pred) = cli.demo_rollout(args)
        torch.cuda.synchronize()
    assert riccati_solve_fused.launches == k2 + 2 * args.qp_iter * 5
    assert solve_ocp_qp_fused.launches == k1
    assert xs.shape == (5, 1, 5) and pred.shape == (5, 1, 21, 5)
    assert all(bool(torch.isfinite(a).all()) for a in (xs, obs, pred))
