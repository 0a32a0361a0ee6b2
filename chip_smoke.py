#!/usr/bin/env python3
"""Bring-up check of the PyTorch port (``doa_mpc_tpu_torch``) on one GPU.

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds kernels K1 (``doa_mpc_tpu_torch/csrc/ip_solve.cu``, two
instantiations: generic and unicycle structure), K2
(``doa_mpc_tpu_torch/csrc/riccati.cu``) and K3
(``doa_mpc_tpu_torch/csrc/irk_step.cu``, the whole IRK step of the unicycle:
its Newton iterations by block LU and its sensitivities) with nvcc for
sm_90a, and the operation counter ``csrc/op_count.cpp``
(``ops/op_count.py``) with g++, one compiler per source, all at once. It
holds each kernel against its plain PyTorch version (K1 in both
instantiations; K3 on the states of a real IRK tick, f32 and f64, in
phase 5), and drives two paths through the
seed-matched Monte-Carlo cell ``20221031_215846`` (RANDOM, TF 2.0, N 20, M
5, 100 seeds x 400 ticks, rk4, 6 IP iterations, f32): the ``fused`` backend
(K1's unicycle instantiation, phase 4) and the ``riccati`` backend (the
interior-point solver with K2, phase 7). Phases 9-10 replay the IRK leg
and the sweeps' corners through K1 and K3; phase 9 also runs one IRK cell
alone, whose rows must equal its rows in the paired run. Phase 11 runs the single-scenario path
through K2 (``RtiController.rti_step``): the ``demo`` command's rollout
(B=1, 20 IP iterations, 200 ticks) and the f64 parametric tick with
per-row goals on the card against the CPU; phase 12 runs the RL
train-and-evaluate driver ``rl/train_eval.py`` at ``results/rl_r5``'s
width (B=128, M=12, EDGE; 2 training episodes and one evaluation episode
per arm, 5 steps each), whose two arms must start from the same worlds and
whose files must carry the committed files' keys; in both, K2's plain
version and the plain Riccati sweep raise if reached. Phase 13 replays the
rk4 seed-matched legs ``prod_rk4_qp6`` and ``prod_fixedbug`` through K1.
Every seed-matched replay (phases 4, 7, 9, 13 and 15) runs through ``doa_mpc_tpu_torch/sim/parity.py`` and so through the
campaign entry point ``sim/experiments.run_scenario_batch`` (its
``compat_rng`` path), the cells of one setting but for the scenario (a
RANDOM/EDGE pair) as one batch. Phase 15
replays a status-4 pair of ``v0_baseline`` through K1 (the analogue armed
with the plant brake), and phase 16 the f64 IRK tick of ``f64_nostatus4``
through K2's f64 entry point against the CPU. Phase 14 runs the production campaign cell
sharded (``parallel/``): in process over a one-card mesh against the
unsharded run (identical rows, 400 K1 launches each, statistics equal to
the rows' sums and minimum), then the ``experiment --distributed`` command
as two gloo ranks on the card (one writer; rates within 0.10), and the same
cell with IRK unsharded and as two ranks (rows equal). Each path
runs with the launch counts set to 0 just before it and read just after.
It times the control ticks (phase 5 takes the fused ticks from the
``bench`` command's ``measure`` and prints its JSON line) and the kernels
(device time from CUDA events around launches queued behind a spin kernel;
K1 for each instantiation and K2 at B=4096, B=1 and the RL batch, B=128),
computes each kernel's bound at the shapes it times from its bytes
(``utils/profiling.py``) and the operations its outputs need, counted from
its code (``ops/op_count.py``), and prints one line per phase.
The line before the last is a JSON object describing each kernel; the last
line is ``{"ok": true, "device": {...}}``. Any failed check raises, so the
script exits non-zero and prints no result; it also does so without CUDA or
outside a checkout of the repository. Long diagnostics go to
``chiprun_out/chip_smoke/``.
"""

import contextlib
import dataclasses
import functools
import json
import os
import shutil
import socket
import subprocess
import sys
import time
import types
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "chiprun_out", "chip_smoke")
PARITY_R5 = os.path.join(REPO, "results", "parity_r5")
HARD_QPS = os.path.join(REPO, "tests", "fixtures", "hard_qps_f32.npz")
B_MAIN, N, M, QP_ITER = 4096, 20, 5, 6
CAPTURE_TICKS = (0, 10, 30)
# tick timing: phase 5 (the zero and IRK ticks; the fused rk4 ticks come
# from the bench) and phase 8 (the solver backends)
TICK_WARMUP, TICK_REPS = 10, 50
SOLVER_WARMUP, SOLVER_REPS = 5, 20
# the depth of phase 10's sweep runs and of phase 11's demo rollout (whose
# robot reaches the goal at tick 135): the ticks are host-bound, so the
# script's time goes with ticks, not seeds
TICKS10, TICKS_DEMO = 100, 200
# K3 launches per IRK tick: the linearization's step (with the
# sensitivities) and the plant step
K3_PER_TICK = 2


_LAP = [time.time()]
START = _LAP[0]


def lap():
    """Seconds since the last call (the wall time of a phase)."""
    now = time.time()
    sec, _LAP[0] = now - _LAP[0], now
    return sec


def _die(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def _check(cond, msg):
    if not cond:
        _die(msg)


def time_ms(torch, fn, reps, warmup=1):
    """CUDA-event timing of ``reps`` calls of ``fn`` after ``warmup`` calls;
    returns ms per call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def kernel_device_ms(torch, fn, reps):
    """Device time per call of ``fn``, a call whose device work is one kernel
    launch: CUDA events around ``reps`` calls queued behind a spin kernel, so
    that the card runs them back to back and the host's enqueue of the
    wrapper does not show. The spin is lengthened until it outlasts the
    enqueue (an event recorded after it is still pending when the last call
    is queued). (``torch.profiler`` saw as few as 6 of 50 launches of the
    short kernel K2 on an H100.)"""
    fn()
    torch.cuda.synchronize()
    cycles = 10**7
    for _ in range(6):
        torch.cuda._sleep(cycles)
        spun = torch.cuda.Event()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        spun.record()
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        drained = spun.query()
        torch.cuda.synchronize()
        if not drained:
            return start.elapsed_time(stop) / reps
        cycles *= 4
    _die(f"the host did not queue {reps} calls within a spin of {cycles // 4} cycles")


def seeded_lqrs(torch, dev, nb=B_MAIN, n=N, seed=0):
    """A batch of LQRs with SPD costs at the solver's width, in float64 on
    ``dev``: Q, R, S, A, B, q, r, d, x0 as kernel K2 takes them."""
    import numpy as np

    rng = np.random.default_rng(seed)
    G = rng.standard_normal((nb, n + 1, 5, 5))
    H = rng.standard_normal((nb, n, 2, 2))
    return [torch.tensor(a, device=dev) for a in (
        G @ np.swapaxes(G, -1, -2) + 0.1 * np.eye(5), H @ np.swapaxes(H, -1, -2) + 0.5 * np.eye(2),
        0.1 * rng.standard_normal((nb, n, 2, 5)),
        0.9 * np.eye(5) + 0.1 * rng.standard_normal((nb, n, 5, 5)),
        rng.standard_normal((nb, n, 5, 2)), rng.standard_normal((nb, n + 1, 5)),
        rng.standard_normal((nb, n, 2)), rng.standard_normal((nb, n, 5)),
        rng.standard_normal((nb, 5)))]


def replay_counted(parity, kernels, leg, s, cells, dev):
    """Replay ``cells`` of ``leg`` with settings ``s`` through
    ``parity.replay`` (cells that differ only in their scenario, as one
    batch), with the launch counts of ``kernels`` (K1's and K2's wrappers)
    set to 0 just before each run and read just after it. Returns the
    ``CellResult`` per cell and one record per run."""
    launches = []

    @contextlib.contextmanager
    def counted(group):
        for k in kernels:
            k.launches = 0
        yield
        launches.append([k.launches for k in kernels])

    results = parity.replay(leg, s, cells, dev, each_run=counted)
    firsts = [r for r in results if parity.cell_id(r.cell) == r.batch[0]]
    runs = [dict(cells=list(r.batch), rows=r.batch_rows, launches=n, wall_s=r.wall_s)
            for r, n in zip(firsts, launches)]
    return results, runs


def check_replay(tag, parity, results, runs, launches, leg_bound=None):
    """The gates of a replayed leg: each run launched the kernels
    ``launches`` times (K1, K2), every row is finite, each cell lies within
    0.10 of its TPU CSV in hit and in reached, and, with ``leg_bound``, the
    cells' seeds together within it. Returns the cells' statistics
    (``parity.cell_stats``) and their aggregate."""
    import numpy as np

    for r in runs:
        _check(r["launches"] == list(launches),
               f"{tag}: run of {r['cells']} launched K1, K2 {r['launches']} times, "
               f"expected {list(launches)}")
    stats = []
    for res in results:
        st = parity.cell_stats(res)
        _check(res.rows.shape == (st["runs"], 7) and np.isfinite(res.rows).all(),
               f"{tag} {st['stamp']}_{st['scenario']}: rows not ({st['runs']}, 7) and finite")
        _check(abs(st["hit"] - st["tpu_hit"]) <= 0.10
               and abs(st["reached"] - st["tpu_reached"]) <= 0.10,
               f"{tag} {st['stamp']}_{st['scenario']}: rates off the TPU CSV: hit {st['hit']} vs "
               f"{st['tpu_hit']}, reached {st['reached']} vs {st['tpu_reached']}")
        stats.append(st)
    agg = parity.aggregate(stats)
    if leg_bound is not None:
        _check(abs(agg["hit"] - agg["tpu_hit"]) <= leg_bound
               and abs(agg["reached"] - agg["tpu_reached"]) <= leg_bound,
               f"{tag}: aggregate rates off the TPU CSVs by more than {leg_bound}: {agg}")
    return stats, agg


def cell_line(st):
    """One replayed cell, H100 against the TPU CSV."""
    return (f"{st['stamp']}_{st['scenario']} TF {st['tf']} qp {st['qp_iter']}"
            f"{' interp' if st['interpolate'] else ''} hit {st['hit']:.2f}/{st['tpu_hit']:.2f} "
            f"reached {st['reached']:.2f}/{st['tpu_reached']:.2f} agree {st['agree_hit']:.2f}/"
            f"{st['agree_reached']:.2f} z {st['hit_mcnemar_z']:.2f}")


def leg_line(name, agg):
    """A replayed leg's seeds together, H100 against the TPU CSVs."""
    return (f"{name} {agg['seeds']} seeds: hit={agg['hit']:.3f} (TPU CSVs {agg['tpu_hit']:.3f}) "
            f"reached={agg['reached']:.3f} (TPU CSVs {agg['tpu_reached']:.3f}); per-seed "
            f"agreement hit={agg['agree_hit']:.3f} reached={agg['agree_reached']:.3f}; hit McNemar "
            f"z={agg['hit_mcnemar_z']:.2f}")


def runs_line(runs):
    return "; ".join(f"{' + '.join(r['cells'])} ({r['rows']} rows) {r['wall_s']:.1f} s"
                     for r in runs)


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def plain_forbidden(ip_qp, riccati_fused):
    """While the block runs, K2's plain version and the plain Riccati sweep
    that ``ops/ip_qp.py`` calls raise: a path on the card that reached
    either would be running on the CPU's formulas instead of the kernel."""
    def forbidden(*a, **k):
        raise AssertionError("the card path reached a plain (CPU) Riccati solve")

    saved = [(riccati_fused, "riccati_solve_fused_ref"), (ip_qp, "riccati_factorize"),
             (ip_qp, "riccati_solve")]
    saved = [(mod, name, getattr(mod, name)) for mod, name in saved]
    for mod, name, _ in saved:
        setattr(mod, name, forbidden)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def main():
    try:
        import torch
    except ImportError:
        _die("torch is not installed")
    if not torch.cuda.is_available():
        _die("torch.cuda.is_available() is False: this check needs an NVIDIA GPU")
    for src in ("ip_solve.cu", "riccati.cu", "irk_step.cu"):
        if not os.path.isfile(os.path.join(REPO, "doa_mpc_tpu_torch", "csrc", src)):
            _die("run from the root of a checkout: doa_mpc_tpu_torch/ is missing")
    sys.path.insert(0, REPO)
    os.makedirs(OUT_DIR, exist_ok=True)

    import numpy as np
    from doa_mpc_tpu_torch.config import SolverOptions, WorldSpec, default_cost_params
    from doa_mpc_tpu_torch import bench, cli
    from doa_mpc_tpu_torch.ops import cuda_build, integrators, ip_fused, ip_qp, riccati_fused
    from doa_mpc_tpu_torch.ops.integrators import irk_step_fused, irk_step_ref
    from doa_mpc_tpu_torch.ops.ip_fused import (
        GENERIC_STRUCTURE, UNICYCLE_QP_STRUCTURE, solve_ocp_qp_fused, solve_ocp_qp_fused_ref)
    from doa_mpc_tpu_torch.ops.ip_qp import solve_ocp_qp
    from doa_mpc_tpu_torch.ops.ocp_qp import OcpQp, normalize_cost
    from doa_mpc_tpu_torch.ops.op_count import OpCounter
    from doa_mpc_tpu_torch.ops.riccati_fused import riccati_solve_fused, riccati_solve_fused_ref
    from doa_mpc_tpu_torch.parallel import mesh as pmesh
    from doa_mpc_tpu_torch.rl import train as rl_train, train_eval
    from doa_mpc_tpu_torch.rl.ddpg import DDPG, ReplayBuffer
    from doa_mpc_tpu_torch.rl.env import SubgoalEnv
    from doa_mpc_tpu_torch.sim import evaluate, experiments, parity
    from doa_mpc_tpu_torch.sim.closed_loop import (
        init_loop_state, make_batched_tick, make_parametric_tick, metrics_of)
    from doa_mpc_tpu_torch.sim.compat_rng import mt_experiment_batch
    from doa_mpc_tpu_torch.sim.experiments import run_scenario_batch
    from doa_mpc_tpu_torch.sim.obstacles import predict_trajectory, robot_start_goal
    from doa_mpc_tpu_torch.solver.sqp_rti import make_rti_controller
    from doa_mpc_tpu_torch.utils.profiling import (
        F32_OPS_PER_S, HBM_BYTES_PER_S, bound, device_label, fused_hbm_bytes, irk_step_bytes,
        time_fn)

    dev = torch.device("cuda", 0)
    card = device_label(dev)
    STRUCTURES = {"generic": GENERIC_STRUCTURE, "unicycle": UNICYCLE_QP_STRUCTURE}

    # ---- phase 1: device -------------------------------------------------
    nvcc_v = subprocess.run([cuda_build.nvcc(), "--version"], capture_output=True,
                            text=True, check=True).stdout.strip().splitlines()[-1]
    print(f"phase 1 device: card={card} torch={torch.__version__} "
          f"cuda={torch.version.cuda} nvcc={nvcc_v!r}; wall {lap():.1f} s", flush=True)

    # ---- phase 2: build the three kernels and the op counter at once ----------
    def timed_build(build):
        t = time.time()
        path = build()
        return path, time.time() - t

    t0 = time.time()
    with ThreadPoolExecutor(max_workers=4) as pool:
        builds = list(pool.map(timed_build, [
            *(functools.partial(cuda_build.build, m.KERNEL_SOURCE)
              for m in (ip_fused, riccati_fused, integrators)), OpCounter]))
    ip_fused._library()
    riccati_fused._library()
    integrators._library()
    opc = builds[3][0]
    build_s = time.time() - t0

    def k2_bound_of(lqr):
        """K2's bytes on the f32 LQR batch ``lqr`` (each input read once; x,
        u and the costate written once), the operations its outputs need,
        and the bound they give: (bytes, operations, ms, bound_by)."""
        nb = lqr[0].shape[0]
        nbytes = 4 * (sum(a.numel() for a in lqr) + nb * ((N + 1) * 5 + N * 2 + N * 5))
        ops = opc.riccati(N) * nb
        return (nbytes, ops) + bound(nbytes, ops)
    print(f"phase 2 build: K1, K2, K3 and the op counter in {build_s:.2f} s (one compiler "
          f"each, in parallel); "
          + "; ".join(f"{name} {sec:.2f} s -> {os.path.relpath(path, REPO)}, ptxas: "
                      + " | ".join(cuda_build.ptxas_report(path))
                      for name, (path, sec) in zip(("K1", "K2", "K3"), builds[:3])), flush=True)
    spills = [ln for ln in cuda_build.ptxas_report(builds[2][0])
              if "spill" in ln and "0 bytes spill stores, 0 bytes spill loads" not in ln]
    _check(not spills, f"K3: ptxas reports spills: {spills}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    k3_plans = {(dt_, sens_): integrators.plan(4, sens_, dt_)
                for dt_ in (torch.float32, torch.float64) for sens_ in (True, False)}
    _check(all(p_.blocks_per_sm > 0 for p_ in k3_plans.values()),
           f"K3: occupancy API reports {k3_plans}")
    print(f"phase 2 K3 (s=4; no spill in any instantiation): "
          + "; ".join(f"{str(dt_).removeprefix('torch.')} {'with' if sens_ else 'without'} D: "
                      f"team of {p_.team} lanes, {p_.rows_per_block} rows per one-warp "
                      f"block, {p_.smem_bytes} B of shared memory per block, "
                      f"{p_.blocks_per_sm} blocks ({p_.blocks_per_sm * p_.rows_per_block}"
                      f" rows) resident per SM" for (dt_, sens_), p_ in k3_plans.items()),
          flush=True)
    for sname, st in STRUCTURES.items():
        k1_plan = ip_fused.plan(B_MAIN, N, M, st)
        per_sm = k1_plan.resident
        _check(per_sm > 0, f"K1 {sname}: occupancy API reports {per_sm}")
        _check(k1_plan.work == 0, f"K1 {sname}: N={N}, M={M} does not fit shared memory")
        print(f"phase 2 K1 {sname} (team of 16 lanes): {ip_fused.smem_bytes(N, M, st) // 2} B "
              f"of shared memory per scenario, {per_sm} scenarios resident per SM (occupancy "
              f"API), {-(-B_MAIN // (per_sm * sms))} wave(s) at B={B_MAIN} (N={N}, M={M})",
              flush=True)
    k2_plan = riccati_fused.plan(B_MAIN, N, torch.float32)
    k2_per_sm = k2_plan.resident
    _check(k2_per_sm > 0, f"K2: occupancy API reports {k2_per_sm}")
    _check(k2_plan.work == 0, f"K2: N={N} does not fit shared memory")
    print(f"phase 2 K2 f32 (team of 16 lanes): "
          f"{riccati_fused.smem_bytes(N, torch.float32) // 2} B of shared memory per "
          f"scenario (stage ring, exchange buffers, scratch), {k2_per_sm} scenarios resident "
          f"per SM (occupancy API), {-(-B_MAIN // (k2_per_sm * sms))} wave(s) at B={B_MAIN} "
          f"(N={N}); wall {lap():.1f} s", flush=True)

    # ---- phase 3: kernel vs plain on real QPs ------------------------------
    spec = WorldSpec(tf=2.0, n_solv=N, n_obst=M, qp_iter=QP_ITER)
    opts = SolverOptions(qp_iter=QP_ITER, integrator="rk4", compat_pred_bug=True)
    ctrl = make_rti_controller(spec, opts, dtype=torch.float32, device=dev)
    params = default_cost_params(spec, dtype=torch.float32, device=dev)
    start, goal = robot_start_goal(spec)
    goal_t = torch.as_tensor(goal, dtype=torch.float32, device=dev)
    obst, noise = mt_experiment_batch(range(B_MAIN), spec, "RANDOM",
                                      max_iter=max(CAPTURE_TICKS) + 1)
    noise = torch.as_tensor(noise, device=dev)
    st = init_loop_state(ctrl, start, goal, batch_shape=(B_MAIN,), obst=obst)
    tick = make_batched_tick(ctrl, goal, params)
    captured = {}
    for t in range(max(CAPTURE_TICKS) + 1):
        if t in CAPTURE_TICKS:
            pred = predict_trajectory(st.obst, spec, N, compat_pred_bug=True).movedim(0, 1)
            captured[t] = OcpQp(*[a.contiguous() for a in
                                  ctrl.build_qp(st.rti, st.x0, goal_t, pred, params)])
        st = tick(st, noise=noise[t])
    torch.cuda.synchronize()

    max_err_1 = {name: 0.0 for name in STRUCTURES}
    rows = {}
    q = torch.tensor([0.5, 0.95], dtype=torch.float64, device=dev)
    for t, qp in captured.items():
        p1 = solve_ocp_qp_fused_ref(qp, iters=1)
        for sname, st in STRUCTURES.items():
            k1 = solve_ocp_qp_fused(qp, iters=1, structure=st)
            torch.cuda.synchronize()
            err = max(float((getattr(k1, f) - getattr(p1, f)).abs().max())
                      for f in ("dx", "du", "s"))
            _check(np.isfinite(err) and err <= 5e-4,
                   f"tick {t}, K1 {sname}: kernel vs plain after 1 iteration differs by "
                   f"{err} > 5e-4")
            max_err_1[sname] = max(max_err_1[sname], err)
        # the oracle is the converged f64 solve (80 iterations), as in
        # scripts/tpu_equiv_check.py
        du_ref = solve_ocp_qp_fused_ref(OcpQp(*[a.double() for a in qp]), iters=80).du
        for iters in (QP_ITER, 50):
            e_p = (solve_ocp_qp_fused_ref(qp, iters=iters).du.double() - du_ref).abs().amax((1, 2))
            mp, pp = torch.quantile(e_p, q).tolist()
            for sname, st in STRUCTURES.items():
                e_k = (solve_ocp_qp_fused(qp, iters=iters, structure=st).du.double()
                       - du_ref).abs().amax((1, 2))
                mk, pk = torch.quantile(e_k, q).tolist()
                ok = mk <= max(2 * mp, 1e-3) and pk <= max(2 * pp, 1e-2)
                rows[f"tick{t}_it{iters}_{sname}"] = dict(kernel_med=mk, kernel_p95=pk,
                                                          plain_med=mp, plain_p95=pp, ok=ok)
                _check(ok, f"tick {t}, {iters} iterations, K1 {sname}: f64 arbitration failed "
                           f"(kernel med {mk:.3g} p95 {pk:.3g}; plain-f32 med {mp:.3g} "
                           f"p95 {pp:.3g})")
    hard = np.load(HARD_QPS)
    hqp = OcpQp(*[torch.as_tensor(hard[f], device=dev) for f in OcpQp._fields])
    hsol = solve_ocp_qp_fused(hqp, iters=int(hard["iters"]), structure=GENERIC_STRUCTURE)
    _check(all(bool(torch.isfinite(a).all()) for a in hsol), "hard_qps_f32.npz: non-finite")
    with open(os.path.join(OUT_DIR, "phase3_arbitration.json"), "w") as f:
        json.dump(rows, f, indent=1)
    print(f"phase 3 kernel-vs-plain: B={B_MAIN} N={N} M={M} ticks {list(CAPTURE_TICKS)}, "
          f"K1 1-iter max|err| "
          + ", ".join(f"{k} {v:.3e}" for k, v in max_err_1.items())
          + f" (atol 5e-4); du vs converged-f64 oracle ok at {QP_ITER} and 50 iterations: "
          + "; ".join(f"{k} k_med={v['kernel_med']:.2e} p_med={v['plain_med']:.2e}"
                      for k, v in rows.items())
          + f"; hard_qps finite (generic); card={card}; wall {lap():.1f} s", flush=True)

    # ---- phase 4: main path, seed-matched cell 20221031_215846 -------------
    # the leg prod_rk4_qp6 (rk4, fused, 6 IP iterations, f32) through
    # sim/parity.py, the cell run alone
    kernels = (solve_ocp_qp_fused, riccati_solve_fused, irk_step_fused)
    leg_prod = parity.load_leg(os.path.join(PARITY_R5, "prod_rk4_qp6"))
    s_prod = parity.leg_settings(leg_prod)
    _check((s_prod.backend, s_prod.integrator, s_prod.qp_iter_override, s_prod.status4,
            s_prod.f64) == ("fused", "rk4", QP_ITER, False, False),
           f"prod_rk4_qp6 is not the rk4 fused f32 leg at {QP_ITER} IP iterations: {s_prod}")
    cell4 = parity.select(leg_prod.cells, "215846")
    res4, runs4 = replay_counted(parity, kernels, leg_prod, s_prod, cell4, dev)
    (st4,), _ = check_replay("phase 4", parity, res4, runs4, (400, 0, 0))
    data, launches, wall = res4[0].rows, runs4[0]["launches"][0], runs4[0]["wall_s"]
    parity.summarize(leg_prod, s_prod, res4, os.path.join(OUT_DIR, "phase4"), card)
    print(f"phase 4 main path (sim/parity.py, prod_rk4_qp6 {st4['stamp']}_{st4['scenario']}, "
          f"rk4, {QP_ITER} IP iters, f32): {st4['runs']} seeds x {s_prod.max_iter} ticks in "
          f"{wall:.1f} s wall; hit={st4['hit']:.2f} (TPU CSV {st4['tpu_hit']:.2f}) "
          f"reached={st4['reached']:.2f} (TPU CSV {st4['tpu_reached']:.2f}); per-seed agreement "
          f"hit={st4['agree_hit']:.2f} reached={st4['agree_reached']:.2f}; K1 launches="
          f"{launches} (unicycle); card={card}; wall {lap():.1f} s", flush=True)

    # ---- phase 5: throughput ------------------------------------------------
    # the fused rk4 ticks at B=4096 and B=1 are the bench's (the `bench`
    # command's configuration and timing); the other ticks through the same
    # timer, utils.profiling.time_fn
    solve_ocp_qp_fused.launches = 0
    bench_json = bench.measure(device=dev)
    bench_k1 = solve_ocp_qp_fused.launches
    want_bench = 2 * (bench.WARMUP + bench_json["chunks"] * (bench_json["chunk_ticks"] + 1))
    _check(bench_k1 == want_bench, f"the bench launched K1 {bench_k1} times, expected {want_bench}")
    _check(bench_json["batch"] == B_MAIN and bench_json["qp_iter"] == QP_ITER
           and all(np.isfinite(v) and v > 0 for v in (bench_json["value"],
                                                      bench_json["b1_device_tick_s"])),
           f"bench: {bench_json}")
    print(json.dumps(bench_json), flush=True)
    ms_4096 = bench_json["p50_chunkmean_tick_s"] * 1e3
    ms_1 = bench_json["b1_p50_chunkmean_tick_s"] * 1e3

    def tick_ms(batch, backend, c=ctrl, warmup=TICK_WARMUP, reps=TICK_REPS):
        gen = torch.Generator(device=dev).manual_seed(0)
        tk = make_batched_tick(c, goal, params, backend=backend, generator=gen)
        state = init_loop_state(c, start, goal, batch_shape=(batch,), generator=gen)
        for _ in range(warmup - 1):      # time_fn's own call is the last
            state = tk(state)
        return time_fn(tk, state, reps=reps) * 1e3

    ms_zero = tick_ms(B_MAIN, "zero")
    ms_zero_1 = tick_ms(1, "zero")
    # the same ticks with the default integrator (IRK in the linearization
    # and the plant)
    ctrl_irk = make_rti_controller(spec, SolverOptions(qp_iter=QP_ITER, compat_pred_bug=True),
                                   dtype=torch.float32, device=dev)
    irk_step_fused.launches = 0
    irk_ms = {(b_, be): tick_ms(b_, be, ctrl_irk)
              for b_ in (B_MAIN, 1) for be in ("fused", "zero")}
    k3_ticks = irk_step_fused.launches
    _check(k3_ticks > 0 and k3_ticks % K3_PER_TICK == 0,
           f"phase 5: the IRK ticks launched K3 {k3_ticks} times, not {K3_PER_TICK} per tick")

    # K3 on the states of a real IRK tick at B=4096: the linearization's
    # step over the B*N stage points (with D) and the plant step over the B
    # rows, captured from the tick
    k3_in = []
    real_k3 = integrators.irk_step_fused

    def capture_k3(*args):
        k3_in.append(tuple(a.clone() if torch.is_tensor(a) else a for a in args))
        return real_k3(*args)

    # the wrapper counts its launch on the function its module name holds
    capture_k3.launches = 0

    gen3 = torch.Generator(device=dev).manual_seed(0)
    st3 = init_loop_state(ctrl_irk, start, goal, batch_shape=(B_MAIN,), generator=gen3)
    tk3 = make_batched_tick(ctrl_irk, goal, params, generator=gen3)
    for _ in range(3):                    # past the cold start
        st3 = tk3(st3)
    integrators.irk_step_fused = capture_k3
    try:
        tk3(st3)
    finally:
        integrators.irk_step_fused = real_k3
    torch.cuda.synchronize()
    _check(len(k3_in) == K3_PER_TICK, f"phase 5: {len(k3_in)} K3 calls in one IRK tick")
    k3_calls = {("lin" if c[7] else "plant"): c for c in k3_in}
    _check(set(k3_calls) == {"lin", "plant"}
           and tuple(k3_calls["lin"][0].shape) == (B_MAIN * N, 5)
           and tuple(k3_calls["plant"][0].shape) == (B_MAIN, 5),
           f"phase 5: K3 calls of rows {[tuple(c[0].shape) for c in k3_in]}, sensitivities "
           f"{[c[7] for c in k3_in]}")

    def outs(v, sens):
        return v if sens else (v,)

    k3_rows, k3_err = {}, 0.0
    for name, (x3, u3, A3, b3, h3, it3, ns3, sens3) in k3_calls.items():
        rest = (h3, it3, ns3, sens3)
        args64 = [t.double() for t in (x3, u3, A3, b3)]
        want64 = outs(irk_step_ref(*args64, *rest), sens3)
        got64 = outs(irk_step_fused(*args64, *rest), sens3)
        got32 = outs(irk_step_fused(x3, u3, A3, b3, *rest), sens3)
        plain32 = outs(irk_step_ref(x3, u3, A3, b3, *rest), sens3)
        torch.cuda.synchronize()
        for o, w, g, g32, p32 in zip(("Phi", "D"), want64, got64, got32, plain32):
            rel64 = float((g - w).abs().max()) / max(1.0, float(w.abs().max()))
            e_k = float((g32.double() - w).abs().max())
            e_p = float((p32.double() - w).abs().max())
            err32 = float((g32 - p32).abs().max())
            _check(rel64 <= 1e-12,
                   f"K3 f64 {name} {o}: relative max|kernel - plain| {rel64:.3e} > 1e-12")
            _check(np.isfinite(e_k) and e_k <= max(2 * e_p, 1e-6),
                   f"K3 f32 {name} {o}: {e_k:.3e} from the f64 plain output, plain f32 "
                   f"{e_p:.3e}")
            k3_rows[f"{name} {o}"] = dict(rows=x3.shape[0], rel64=rel64, err32=err32, e_k=e_k,
                                          e_p=e_p)
            if name == "lin":
                k3_err = max(k3_err, err32)
        # slices of the rows alone give the bits they have in the full batch
        rows3 = x3.shape[0]
        for sl in (slice(0, 1), slice(1000, 1037), slice(rows3 - 20, rows3)):
            part = outs(irk_step_fused(x3[sl].clone(), u3[sl].clone(), A3, b3, *rest), sens3)
            _check(all(torch.equal(p, g[sl]) for p, g in zip(part, got32)),
                   f"K3 {name}: rows {sl.start}-{sl.stop} alone differ from the full batch")
    # device times of the kernel (one launch per call) and of its plain
    # version, on the captured inputs
    k3_times = {}
    for name, (x3, u3, A3, b3, h3, it3, ns3, sens3) in k3_calls.items():
        rows3, s3 = x3.shape[0], A3.shape[0]
        nbytes = irk_step_bytes(rows3, s3, sens3, 4)
        nops = opc.irk_step(rows3, s3, it3, ns3, sens3)
        bound3, by3 = bound(nbytes, nops)
        args = (x3, u3, A3, b3, h3, it3, ns3, sens3)
        k3_times[name] = dict(
            rows=rows3, sens=sens3,
            ms=kernel_device_ms(torch, lambda a=args: irk_step_fused(*a), 20),
            plain_ms=time_ms(torch, lambda a=args: irk_step_ref(*a), reps=3, warmup=1),
            bytes=nbytes, ops=nops, bound_ms=bound3, bound_by=by3)
    with open(os.path.join(OUT_DIR, "phase5_k3.json"), "w") as f:
        json.dump({"check": k3_rows, "times": k3_times}, f, indent=1)
    qp = captured[30]
    qp1 = OcpQp(*[a[:1].contiguous() for a in qp])
    uni = UNICYCLE_QP_STRUCTURE

    def k1_call(qpx, st=uni):
        return lambda: solve_ocp_qp_fused(qpx, iters=QP_ITER, structure=st)

    def k1_kernel(qpx, st, iters=QP_ITER):
        # the QP normalized once, as the wrapper would: the call's device work
        # is then the kernel and the fill of kappa (B floats)
        qn = OcpQp(*[a.contiguous() for a in normalize_cost(qpx)[0]])
        return lambda: solve_ocp_qp_fused(qn, iters=iters, normalize=False, structure=st)

    # device time of the kernel for each instantiation; the wrapper
    # (normalize + launch) with CUDA events
    k1_dev = {(sname, nb): kernel_device_ms(torch, k1_kernel(qx, st), 20)
              for sname, st in STRUCTURES.items() for nb, qx in ((B_MAIN, qp), (1, qp1))}
    k1_ms = k1_dev[("unicycle", B_MAIN)]
    k1_call_ms = time_ms(torch, k1_call(qp), reps=20, warmup=2)
    k1_call_ms_1 = time_ms(torch, k1_call(qp1), reps=20, warmup=2)
    plain_ms = time_ms(torch, lambda: solve_ocp_qp_fused_ref(qp, iters=QP_ITER), reps=3, warmup=1)
    mem = torch.cuda.max_memory_allocated() / 2**20
    with open(os.path.join(OUT_DIR, "phase5_k1_device_ms.json"), "w") as f:
        json.dump({f"{s_}_B{b_}": v for (s_, b_), v in k1_dev.items()}, f, indent=1)
    print(f"phase 5 throughput: B={B_MAIN} tick {ms_4096:.4f} ms = "
          f"{B_MAIN / ms_4096 * 1e3:.0f} solves/s (bench: median of "
          f"{bench_json['chunks']} chains of {bench_json['chunk_ticks']} ticks, "
          f"{bench_json['min_chunkmean_tick_s'] * 1e3:.4f}-"
          f"{bench_json['max_chunkmean_tick_s'] * 1e3:.4f} ms; K1 launches {bench_k1}); "
          f"glue-only (zero backend) tick {ms_zero:.4f} ms | B=1 tick {ms_1:.4f} ms (bench); "
          f"glue-only {ms_zero_1:.4f} ms (zero and IRK ticks: {TICK_WARMUP} warm-up + "
          f"{TICK_REPS} timed ticks each) | IRK: "
          f"B={B_MAIN} tick {irk_ms[(B_MAIN, 'fused')]:.4f} ms = "
          f"{B_MAIN / irk_ms[(B_MAIN, 'fused')] * 1e3:.0f} solves/s; glue-only "
          f"{irk_ms[(B_MAIN, 'zero')]:.4f} ms | B=1 tick {irk_ms[(1, 'fused')]:.4f} ms; "
          f"glue-only {irk_ms[(1, 'zero')]:.4f} ms | "
          f"K1 (N={N}, M={M}, {QP_ITER} iters, f32) device time per launch (CUDA events "
          f"behind a spin, 20 launches, kappa fill included): "
          + "; ".join(f"{s_} B={b_} {v:.4f} ms" for (s_, b_), v in k1_dev.items())
          + f" | unicycle wrapper (normalize + launch, CUDA events) "
          f"{k1_call_ms:.4f} ms at B={B_MAIN}, {k1_call_ms_1:.4f} ms at B=1; plain version "
          f"{plain_ms:.3f} ms/solve | K3 on a real IRK tick's states (B={B_MAIN}): "
          + "; ".join(f"{k} ({v['rows']} rows) f64 rel max|kernel-plain| {v['rel64']:.2e} "
                      f"(limit 1e-12), f32 max|kernel-plain| {v['err32']:.2e}, vs f64 "
                      f"kernel/plain {v['e_k']:.2e}/{v['e_p']:.2e}" for k, v in k3_rows.items())
          + "; rows alone = rows in the batch (3 slices each); device time (CUDA events "
          "behind a spin, 20 launches): "
          + "; ".join(f"{k} ({v['rows']} rows{', with D' if v['sens'] else ''}) "
                      f"{v['ms']:.4f} ms, bound {v['bound_ms']:.5f} ms ({v['bound_by']}: "
                      f"{v['bytes']} B, {v['ops']} operations), plain version "
                      f"{v['plain_ms']:.3f} ms" for k, v in k3_times.items())
          + f"; K3 launches in the IRK ticks {k3_ticks} ({K3_PER_TICK} per tick)"
          f" | peak mem {mem:.0f} MiB; card={card}; wall {lap():.1f} s", flush=True)

    # ---- phase 6: K2 against its plain version --------------------------------
    # (a) seeded LQR batches with SPD costs, at the solver's full width
    lqr64 = seeded_lqrs(torch, dev)
    lqr32 = [a.float() for a in lqr64]
    k64, p64 = riccati_solve_fused(*lqr64), riccati_solve_fused_ref(*lqr64)
    k32, p32 = riccati_solve_fused(*lqr32), riccati_solve_fused_ref(*lqr32)
    torch.cuda.synchronize()
    rel64 = max(float((k - p).abs().max()) / max(1.0, float(p.abs().max()))
                for k, p in zip(k64, p64))
    _check(rel64 <= 1e-9, f"K2 f64 vs plain f64: relative max|err| {rel64:.3e} > 1e-9")
    k2_err = max(float((k - p).abs().max()) for k, p in zip(k32, p32))
    e32 = [(float((k.double() - w).abs().max()), float((p.double() - w).abs().max()))
           for k, p, w in zip(k32, p32, p64)]
    _check(all(np.isfinite(ek) and ek <= 2 * ep for ek, ep in e32),
           f"K2 f32 further from the f64 plain output than 2x the plain f32 version: {e32}")
    # the single-robot case: B=1 in both dtypes
    lqr64_1 = [a[:1].contiguous() for a in lqr64]
    rel64_1 = max(float((k - p).abs().max()) / max(1.0, float(p.abs().max()))
                  for k, p in zip(riccati_solve_fused(*lqr64_1), riccati_solve_fused_ref(*lqr64_1)))
    _check(rel64_1 <= 1e-9, f"K2 f64 at B=1 vs plain f64: relative max|err| {rel64_1:.3e} > 1e-9")
    lqr32_1 = [a.float() for a in lqr64_1]
    e32_1 = [(float((k.double() - w).abs().max()), float((p.double() - w).abs().max()))
             for k, p, w in zip(riccati_solve_fused(*lqr32_1), riccati_solve_fused_ref(*lqr32_1),
                                riccati_solve_fused_ref(*lqr64_1))]
    _check(all(np.isfinite(ek) and ek <= 2 * ep for ek, ep in e32_1),
           f"K2 f32 at B=1 further from the f64 plain output than 2x plain f32: {e32_1}")
    k2_work = {dt: riccati_fused.plan(B_MAIN, N, dt).work
               for dt in (torch.float32, torch.float64)}

    # (b) real build_qp QPs: the riccati backend against the torch backend
    # after 1 iteration, then both in f32 against the converged f64 oracle
    max_err_k2_qp = 0.0
    rows2 = {}
    for t, qp in captured.items():
        a1 = solve_ocp_qp(qp, iters=1, backend="riccati")
        b1 = solve_ocp_qp(qp, iters=1, backend="torch")
        err = max(float((getattr(a1, f) - getattr(b1, f)).abs().max()) for f in ("dx", "du", "s"))
        _check(np.isfinite(err) and err <= 5e-4,
               f"tick {t}: riccati vs torch backend after 1 iteration differs by {err} > 5e-4")
        max_err_k2_qp = max(max_err_k2_qp, err)
        du_ref = solve_ocp_qp(OcpQp(*[a.double() for a in qp]), iters=80, backend="torch").du
        for iters in (QP_ITER, 50):
            e_k = (solve_ocp_qp(qp, iters=iters, backend="riccati").du.double()
                   - du_ref).abs().amax((1, 2))
            e_p = (solve_ocp_qp(qp, iters=iters, backend="torch").du.double()
                   - du_ref).abs().amax((1, 2))
            q = torch.tensor([0.5, 0.95], dtype=torch.float64, device=dev)
            (mk, pk), (mp, pp) = torch.quantile(e_k, q).tolist(), torch.quantile(e_p, q).tolist()
            ok = mk <= max(2 * mp, 1e-3) and pk <= max(2 * pp, 1e-2)
            rows2[f"tick{t}_it{iters}"] = dict(riccati_med=mk, riccati_p95=pk,
                                               torch_med=mp, torch_p95=pp, ok=ok)
            _check(ok, f"tick {t}, {iters} iterations: f64 arbitration of the riccati backend "
                       f"failed (med {mk:.3g} p95 {pk:.3g}; torch-f32 med {mp:.3g} p95 {pp:.3g})")
    # (c) the captured hard QPs recover through K2
    hsol2 = solve_ocp_qp(hqp, iters=50, backend="riccati")
    _check(all(bool(torch.isfinite(a).all()) for a in hsol2), "hard_qps_f32.npz: non-finite (K2)")
    hard_mu = float(hsol2.mu.max())
    _check(hard_mu < 1e-2, f"hard_qps_f32.npz through K2: max mu {hard_mu} >= 1e-2")
    with open(os.path.join(OUT_DIR, "phase6_arbitration.json"), "w") as f:
        json.dump(rows2, f, indent=1)
    print(f"phase 6 K2-vs-plain: LQR B={B_MAIN} N={N}: f64 rel max|err|={rel64:.3e} (limit "
          f"1e-9); f32 max|kernel-plain|={k2_err:.3e}, vs f64 plain kernel/plain "
          + ", ".join(f"{ek:.2e}/{ep:.2e}" for ek, ep in e32)
          + f"; B=1: f64 rel {rel64_1:.3e}, f32 kernel/plain "
          + ", ".join(f"{ek:.2e}/{ep:.2e}" for ek, ep in e32_1)
          + f"; device-memory workspace at B={B_MAIN}: {k2_work[torch.float32]} values (f32), "
          f"{k2_work[torch.float64]} (f64), 0 = scratch on chip | real QPs ticks "
          f"{list(CAPTURE_TICKS)}: riccati vs torch backend 1-iter "
          f"max|err|={max_err_k2_qp:.3e} (atol 5e-4); f64 arbitration ok: "
          + "; ".join(f"{k} r_med={v['riccati_med']:.2e} t_med={v['torch_med']:.2e}"
                      for k, v in rows2.items())
          + f" | hard_qps 50 iters max mu {hard_mu:.2e}; card={card}; wall {lap():.1f} s", flush=True)

    # ---- phase 7: the riccati path, seed-matched cell 20221031_215846 -------
    s7 = dataclasses.replace(s_prod, backend="riccati")
    res7, runs7 = replay_counted(parity, kernels, leg_prod, s7, cell4, dev)
    (st7,), _ = check_replay("phase 7", parity, res7, runs7, (0, 400 * QP_ITER * 2, 0))
    data_r = res7[0].rows
    parity.summarize(leg_prod, s7, res7, os.path.join(OUT_DIR, "phase7"), card)
    print(f"phase 7 riccati path (sim/parity.py --backend riccati): {st7['runs']} seeds x "
          f"{s7.max_iter} ticks in {runs7[0]['wall_s']:.1f} s wall; hit={st7['hit']:.2f} (TPU CSV "
          f"{st7['tpu_hit']:.2f}) reached={st7['reached']:.2f} (TPU CSV {st7['tpu_reached']:.2f}); "
          f"per-seed agreement with the TPU CSV hit={st7['agree_hit']:.2f} "
          f"reached={st7['agree_reached']:.2f}, with phase 4's fused run "
          f"hit={(data_r[:, 0] == data[:, 0]).mean():.2f} "
          f"reached={(data_r[:, 1] == data[:, 1]).mean():.2f} (reported, not checked); "
          f"K2 launches={runs7[0]['launches'][1]}; card={card}; wall {lap():.1f} s", flush=True)

    # ---- phase 8: solver-backend ticks and K2 time ---------------------------
    solver = dict(warmup=SOLVER_WARMUP, reps=SOLVER_REPS)
    ms_r = tick_ms(B_MAIN, "riccati", **solver)
    ms_t = tick_ms(B_MAIN, "torch", **solver)
    ms_r1 = tick_ms(1, "riccati", **solver)
    k2_call_ms = time_ms(torch, lambda: riccati_solve_fused(*lqr32), reps=50, warmup=3)
    k2_ms = kernel_device_ms(torch, lambda: riccati_solve_fused(*lqr32), 50)
    k2_ms_1 = kernel_device_ms(torch, lambda: riccati_solve_fused(*lqr32_1), 20)
    k2_plain_ms = time_ms(torch, lambda: riccati_solve_fused_ref(*lqr32), reps=5, warmup=1)
    print(f"phase 8 solver backends: B={B_MAIN} tick riccati {ms_r:.4f} ms = "
          f"{B_MAIN / ms_r * 1e3:.0f} solves/s; torch {ms_t:.4f} ms = "
          f"{B_MAIN / ms_t * 1e3:.0f} solves/s; B=1 tick riccati {ms_r1:.4f} ms "
          f"({SOLVER_WARMUP} warm-up + {SOLVER_REPS} timed ticks, N={N}, M={M}, "
          f"{QP_ITER} iters, f32) | K2 device time per launch "
          f"(CUDA events behind a spin): {k2_ms:.4f} ms at B={B_MAIN} (50 launches), {k2_ms_1:.4f} ms at B=1 (20); "
          f"wrapper (checks, outputs, launch; CUDA events) {k2_call_ms:.4f} ms/call; plain "
          f"version {k2_plain_ms:.3f} ms/call (B={B_MAIN}, N={N}, f32); card={card}; wall {lap():.1f} s", flush=True)

    # ---- phase 9: the IRK seed-matched leg, all 10 cells of v1_nostatus4 ----
    # each RANDOM/EDGE pair as one batch of 200 rows; one cell also alone,
    # to count the rows that pairing leaves as they were
    leg9 = parity.load_leg(os.path.join(PARITY_R5, "v1_nostatus4"))
    s9 = parity.leg_settings(leg9)
    _check((s9.integrator, s9.backend, s9.status4, s9.f64) == ("irk", "fused", False, False),
           f"results/parity_r5/v1_nostatus4 is not the IRK fused f32 leg: {s9}")
    res9, runs9 = replay_counted(parity, kernels, leg9, s9, leg9.cells, dev)
    stats9, agg9 = check_replay("phase 9", parity, res9, runs9, (400, 0, 400 * K3_PER_TICK),
                                leg_bound=0.04)
    parity.summarize(leg9, s9, res9, os.path.join(OUT_DIR, "phase9"), card)
    alone9, runs9a = replay_counted(parity, kernels, leg9, s9,
                                    parity.select(leg9.cells, "220136"), dev)
    check_replay("phase 9 (alone)", parity, alone9, runs9a, (400, 0, 400 * K3_PER_TICK))
    paired9 = next(r.rows for r in res9 if r.cell is alone9[0].cell)
    same9 = int((paired9 == alone9[0].rows).all(1).sum())
    outcome9 = int((paired9[:, [0, 1, 4, 5]] == alone9[0].rows[:, [0, 1, 4, 5]]).all(1).sum())
    _check(same9 == len(paired9), f"phase 9: {alone9[0].cell['stamp']}_EDGE run alone gives "
                                  f"{same9} of {len(paired9)} rows equal to its paired rows")
    print(f"phase 9 IRK seed-matched leg (v1_nostatus4 through sim/parity.py: fused, 4-stage "
          f"Gauss-Legendre IRK with 3 Newton iterations, status-4 off, compat_pred_bug, f32, 100 "
          f"seeds x 400 ticks per cell; {len(runs9)} runs of a RANDOM/EDGE pair each, K1 "
          f"launches 400 and K3 {400 * K3_PER_TICK} each): " + "; ".join(cell_line(st) for st in stats9)
          + f" (H100/TPU CSV; per-seed agreement hit/reached) | runs: {runs_line(runs9)} | "
          + leg_line("v1_nostatus4", agg9)
          + f" | {alone9[0].cell['stamp']}_EDGE run alone ({runs9a[0]['wall_s']:.1f} s): "
          f"{same9} of {len(paired9)} rows equal to its rows in the paired run (gate: all), "
          f"{outcome9} in hit, reached, steps and oob; card={card}; "
          f"wall {lap():.1f} s", flush=True)

    # ---- phase 10: the sweeps' widest corners at full width ------------------
    out10 = os.path.join(OUT_DIR, "phase10")
    shutil.rmtree(out10, ignore_errors=True)
    runs10 = []
    run_batch = experiments.run_scenario_batch

    def counted_batch(spec_, opts_, scenario, **kw):
        """``run_scenario_batch`` with the launch counts set to 0 before each
        (configuration, scenario) and read after it."""
        solve_ocp_qp_fused.launches = riccati_solve_fused.launches = 0
        irk_step_fused.launches = 0
        t0 = time.time()
        d = run_batch(spec_, opts_, scenario, **kw)
        runs10.append(dict(N=spec_.n_solv, M=spec_.n_obst, qp_iter=opts_.qp_iter,
                           integrator=opts_.integrator, scenario=scenario,
                           k1=solve_ocp_qp_fused.launches, k2=riccati_solve_fused.launches,
                           k3=irk_step_fused.launches,
                           hit=d[:, 0].mean(), reached=d[:, 1].mean(), wall_s=time.time() - t0))
        return d

    experiments.run_scenario_batch = counted_batch
    try:
        experiments.run_horizon_sweep(tf_values=(0.5, 3.0), n_obst_values=(5, 30), n_runs=100,
                                      max_iter=TICKS10, out_dir=os.path.join(out10, "horizon"),
                                      verbose=False, device=dev)
        experiments.run_qp_iter_sweep(qp_iters=(150,), n_runs=100, max_iter=TICKS10,
                                      out_dir=os.path.join(out10, "qp_iter"), verbose=False,
                                      device=dev)
    finally:
        experiments.run_scenario_batch = run_batch
    _check(len(runs10) == 10, f"phase 10: {len(runs10)} runs, expected 4 x 2 + 1 x 2")
    for r in runs10:
        _check(r["k1"] == TICKS10 and r["k2"] == 0 and r["integrator"] == "irk"
               and r["k3"] == TICKS10 * K3_PER_TICK,
               f"phase 10: {r}: expected {TICKS10} K1 and {TICKS10 * K3_PER_TICK} K3 launches "
               f"with IRK")
    ref_keys = {"slack", "random_move", "init_guess", "scenario", "TF", "N_SOLV", "N_OBST",
                "QP_ITER"}
    summary10 = []
    for sub, n_pairs in (("horizon", 8), ("qp_iter", 2)):
        pairs = evaluate.load_experiment_data(os.path.join(out10, sub))
        _check(len(pairs) == n_pairs, f"phase 10 {sub}: {len(pairs)} CSV/JSON pairs, "
                                      f"expected {n_pairs}")
        for exp, d in pairs:
            _check(ref_keys <= set(exp) and exp["engine"] == "doa_mpc_tpu_torch"
                   and exp["integrator"] == "irk" and exp["backend"] == "fused",
                   f"phase 10 {sub}: spec JSON {exp} lacks the reference schema")
            _check(d.shape == (100, 6) and np.isfinite(d).all(),
                   f"phase 10 {sub}: {exp}: metric rows not (100, 6) and finite")
        summary10 += evaluate.summarize(os.path.join(out10, sub))
    with open(os.path.join(out10, "phase10_runs.json"), "w") as f:
        json.dump({"runs": runs10, "summarize": summary10}, f, indent=1)
    plan30 = ip_fused.plan(100, 30, 30, uni)
    smem30, per_sm30 = ip_fused.smem_bytes(30, 30, uni) // 2, plan30.resident
    _check(per_sm30 > 0 and plan30.work == 0,
           "K1 at N=30, M=30 does not run from shared memory")
    print(f"phase 10 sweep corners (100 seeds x {TICKS10} ticks, IRK, fused, f32, RANDOM and "
          f"EDGE; K1 launches {TICKS10}, K3 {TICKS10 * K3_PER_TICK} per run): "
          + "; ".join(f"N={r['N']} M={r['M']} qp {r['qp_iter']} {r['scenario']} hit "
                      f"{r['hit']:.2f} reached {r['reached']:.2f} {r['wall_s']:.1f} s"
                      for r in runs10)
          + f" | evaluate.summarize over {len(summary10)} pairs: "
          + "; ".join(f"{r['scenario']} TF {r['TF']} M {r['N_OBST']} qp {r['QP_ITER']} "
                      f"collision {r['collision']:.2f} reached {r['reached']:.2f} "
                      f"median steps {r['median_steps']:.0f}" for r in summary10)
          + f" | K1 unicycle at N=30, M=30: {smem30} B of shared memory per scenario, "
          f"{per_sm30} scenarios resident per SM, {-(-100 // (per_sm30 * sms))} wave(s) at "
          f"B=100; card={card}; wall {lap():.1f} s", flush=True)

    # K1 at the sweeps' shapes, on QPs the IRK controller builds there (B=100,
    # compat_rng RANDOM worlds, tick 10)
    def sweep_qp(spec_, opts_, ticks=10, nb=100):
        c_ = make_rti_controller(spec_, opts_, dtype=torch.float32, device=dev)
        p_ = default_cost_params(spec_, dtype=torch.float32, device=dev)
        obst_, noise_ = mt_experiment_batch(range(nb), spec_, "RANDOM", max_iter=ticks)
        noise_ = torch.as_tensor(noise_, device=dev)
        s_ = init_loop_state(c_, start, goal, batch_shape=(nb,), obst=obst_)
        tk = make_batched_tick(c_, goal, p_)
        for t in range(ticks):
            s_ = tk(s_, noise=noise_[t])
        pred_ = predict_trajectory(s_.obst, spec_, spec_.n_solv).movedim(0, 1)
        return OcpQp(*[a.contiguous() for a in c_.build_qp(s_.rti, s_.x0, goal_t, pred_, p_)])

    new_shapes = {}
    for (n_, m_, it) in ((30, 30, 50), (20, 5, 150)):
        qx = sweep_qp(WorldSpec(tf=n_ / 10, n_solv=n_, n_obst=m_, qp_iter=it),
                      SolverOptions(qp_iter=it))
        err = max(float((getattr(solve_ocp_qp_fused(qx, iters=1, structure=uni), f_)
                         - getattr(solve_ocp_qp_fused_ref(qx, iters=1), f_)).abs().max())
                  for f_ in ("dx", "du", "s"))
        _check(np.isfinite(err) and err <= 5e-4,
               f"K1 at N={n_}, M={m_}: kernel vs plain after 1 iteration differs by {err}")
        ms_ = kernel_device_ms(torch, k1_kernel(qx, uni, it), 10)
        plain_ = time_ms(torch, lambda: solve_ocp_qp_fused_ref(qx, iters=it), reps=1, warmup=1)
        t0 = time.time()
        ops_ = opc.ip_solve(qx, it, uni)
        bytes_ = fused_hbm_bytes(WorldSpec(n_solv=n_, n_obst=m_), 100)
        bound_, by_ = bound(bytes_, ops_)
        new_shapes[f"N{n_}_M{m_}_it{it}"] = dict(ms=ms_, plain_ms=plain_, err_1=err, ops=ops_,
                                                 bytes=bytes_, bound_ms=bound_, bound_by=by_,
                                                 count_s=time.time() - t0)
    with open(os.path.join(out10, "k1_sweep_shapes.json"), "w") as f:
        json.dump(new_shapes, f, indent=1)
    print("phase 10 K1 at the sweeps' shapes (unicycle, B=100, f32, IRK controller QPs of "
          "tick 10; device time by CUDA events behind a spin, 10 launches): "
          + "; ".join(f"{k} {v['ms']:.4f} ms (plain version {v['plain_ms']:.1f} ms; 1-iter "
                      f"max|err| {v['err_1']:.2e}), bound {v['bound_ms']:.5f} ms ({v['bound_by']}: "
                      f"{v['bytes']} B, {v['ops']} operations counted in {v['count_s']:.1f} s)"
                      for k, v in new_shapes.items())
          + f"; card={card}; wall {lap():.1f} s", flush=True)

    # ---- phase 11: the single-scenario path and demo, K2 through rti_step ----
    # the demo command's own configuration (B=1, N=20, M=5, 20 IP iterations,
    # rk4, f32, seed 1), without its GIF, cut to TICKS_DEMO ticks; K2's plain
    # version and the plain Riccati sweep raise if a CUDA tensor reaches them
    demo_args = cli.build_parser().parse_args(["demo", "--device", "cuda",
                                               "--max-iter", str(TICKS_DEMO)])
    n_demo, it_demo = demo_args.max_iter, demo_args.qp_iter
    solve_ocp_qp_fused.launches = riccati_solve_fused.launches = 0
    t0 = time.time()
    with plain_forbidden(ip_qp, riccati_fused):
        dspec, _, _, dfin, (dxs, dobs, dpred) = cli.demo_rollout(demo_args)
        torch.cuda.synchronize()
    wall_demo = time.time() - t0
    k2_demo, k1_demo = riccati_solve_fused.launches, solve_ocp_qp_fused.launches
    _check(k2_demo == 2 * it_demo * n_demo and k1_demo == 0,
           f"phase 11 demo: K2 launched {k2_demo} times (expected {2 * it_demo * n_demo}), "
           f"K1 {k1_demo} times (expected 0)")
    _check(dxs.shape == (n_demo, 1, 5) and dobs.shape == (n_demo, 1, dspec.n_obst, 2)
           and dpred.shape == (n_demo, 1, dspec.n_solv + 1, 5)
           and all(bool(torch.isfinite(a).all()) for a in (dxs, dobs, dpred)),
           "phase 11 demo: collected arrays not finite or of the wrong shape")
    dm = metrics_of(dfin)

    # the parametric tick in f64 (K2's f64 entry) on the card and on the CPU
    # from the same state: B=8, eight goals, noise-free, 10 ticks
    spec64 = WorldSpec(tf=2.0, n_solv=N, n_obst=M, qp_iter=it_demo)
    opts64 = SolverOptions(qp_iter=it_demo, integrator="rk4")
    obst8, _ = mt_experiment_batch(range(8), spec64, "RANDOM", max_iter=1, dtype=np.float64)
    goals8 = np.stack([np.linspace(-6.0, 6.0, 8), np.linspace(6.0, -3.0, 8)], -1)
    runs64 = {}
    for where in (dev, torch.device("cpu")):
        c64 = make_rti_controller(spec64, opts64, dtype=torch.float64, device=where)
        p64 = default_cost_params(spec64, dtype=torch.float64, device=where)
        s64 = init_loop_state(c64, start, goal, batch_shape=(8,), obst=obst8)
        g64 = torch.as_tensor(goals8, dtype=torch.float64, device=where)
        tk64 = make_parametric_tick(c64, random_move=False)
        riccati_solve_fused.launches = 0
        t0 = time.time()
        for _ in range(10):
            s64 = tk64(s64, g64, p64)
        runs64[where.type] = (s64, riccati_solve_fused.launches, time.time() - t0)
    err64 = float((runs64["cuda"][0].x0.cpu() - runs64["cpu"][0].x0).abs().max())
    _check(runs64["cuda"][1] == 2 * it_demo * 10 and runs64["cpu"][1] == 0,
           f"phase 11 f64: K2 launches {runs64['cuda'][1]} on the card, {runs64['cpu'][1]} on CPU")
    _check(err64 <= 1e-7, f"phase 11 f64: card vs CPU x0 max|err| {err64:.3e} > 1e-7")
    lqr64_8 = [a[:8].contiguous() for a in lqr64]
    rel64_8 = max(float((k - p).abs().max()) / max(1.0, float(p.abs().max()))
                  for k, p in zip(riccati_solve_fused(*lqr64_8), riccati_solve_fused_ref(*lqr64_8)))
    _check(rel64_8 <= 1e-9, f"K2 f64 at B=8 vs plain f64: relative max|err| {rel64_8:.3e}")
    print(f"phase 11 single-scenario path: demo rollout (B=1, N={dspec.n_solv}, M={dspec.n_obst}, "
          f"{it_demo} IP iters, rk4, f32, seed {demo_args.seed}) {n_demo} ticks in {wall_demo:.1f} s = "
          f"{wall_demo / n_demo * 1e3:.2f} ms/tick; reached={bool(dm.reached[0])} "
          f"hit={bool(dm.hit[0])} min_margin={float(dm.min_margin[0]):.3f} "
          f"steps={int(dm.steps[0])}; K2 launches={k2_demo} (2 x {it_demo} x {n_demo}), K1 0; "
          f"no plain-version call | f64 parametric tick B=8, per-row goals, noise-free, 10 ticks: "
          f"card vs CPU x0 max|err|={err64:.3e} (limit 1e-7), {runs64['cuda'][2]:.2f} s on the "
          f"card ({runs64['cuda'][1]} K2 f64 launches), {runs64['cpu'][2]:.2f} s on the CPU; K2 "
          f"f64 at B=8 rel max|err| {rel64_8:.3e}; card={card}; wall {lap():.1f} s", flush=True)

    # ---- phase 12: the RL train-and-evaluate driver at rl_r5's width ----------
    # python -m doa_mpc_tpu_torch.rl.train_eval at results/rl_r5's settings:
    # SubgoalEnv B=128, N=20, M=12, EDGE, 10 IP iterations, rk4, f32, 10 ticks
    # per step; DDPG at its defaults (hidden 128x128, buffer 100,000, batch
    # 256) but act_limit 7.2. Only the depth is cut: 2 training episodes and
    # one evaluation episode per arm, of at most 5 steps each
    out12 = os.path.join(OUT_DIR, "phase12")
    argv12 = ["--episodes", "2", "--max-steps", "5", "--eval-episodes", "1", "--scenario",
              "EDGE", "--n-obst", "12", "--out", out12]
    step_ms, update_ms, bufs, resets = [], [], [], []

    def timed(fn, out):
        def call(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = fn(*a, **k)
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t) * 1e3)
            return res
        return call

    def recording_create(*a, **k):
        bufs.append(ReplayBuffer.create(*a, **k))
        return bufs[-1]

    def recording_reset(self, generator, scenario=None):
        st, obs = env_reset(self, generator, scenario)
        resets.append((len(step_ms), [t.clone() for t in (st.loop.x0, *st.loop.obst)]))
        return st, obs

    env_step, env_reset, ddpg_update = SubgoalEnv.step, SubgoalEnv.reset, DDPG.update
    SubgoalEnv.step, SubgoalEnv.reset = timed(env_step, step_ms), recording_reset
    DDPG.update = timed(ddpg_update, update_ms)
    rl_train.ReplayBuffer = types.SimpleNamespace(create=recording_create)
    os.makedirs(out12, exist_ok=True)
    solve_ocp_qp_fused.launches = riccati_solve_fused.launches = 0
    t0 = time.time()
    try:
        with plain_forbidden(ip_qp, riccati_fused), \
                open(os.path.join(out12, "train_eval.log"), "w") as log, \
                contextlib.redirect_stdout(log):
            run12 = train_eval.main(argv12)
    finally:
        rl_train.ReplayBuffer = ReplayBuffer
        SubgoalEnv.step, SubgoalEnv.reset, DDPG.update = env_step, env_reset, ddpg_update
    wall_rl = time.time() - t0
    k2_rl, k1_rl = riccati_solve_fused.launches, solve_ocp_qp_fused.launches
    env, agent, hist, ev12 = run12
    steps_rl = len(step_ms)
    ticks_rl = steps_rl * env.k_ticks
    train_steps = resets[2][0] if len(resets) == 4 else None
    _check(env.batch == 128 and env.spec.n_obst == 12 and env.scenario == "EDGE"
           and agent.cfg.act_limit == 7.2, "phase 12: not rl_r5's settings")
    _check(len(hist) == 2 and all(np.isfinite([h["reward"], h["reached"]]).all() for h in hist),
           f"phase 12: history {hist}")
    _check(k2_rl == 2 * env.opts.qp_iter * ticks_rl and k1_rl == 0,
           f"phase 12: K2 launched {k2_rl} times in {ticks_rl} ticks, K1 {k1_rl} times")
    _check(len(resets) == 4, f"phase 12: {len(resets)} resets, expected 2 training episodes "
                             f"and one evaluation episode per arm")
    _check(len(bufs) == 1 and bufs[0].size == env.batch * train_steps,
           f"phase 12: the buffer holds {bufs[0].size if bufs else None} rows after "
           f"{train_steps} training steps of {env.batch}")
    _check(all(bool(torch.isfinite(p).all()) for p in agent.actor.parameters()),
           "phase 12: non-finite actor weights")
    _check(all(torch.equal(a, b) for a, b in zip(resets[2][1], resets[3][1])),
           "phase 12: the two arms' episode-0 reset worlds differ")
    lay12, lay_r5 = train_eval.layout(out12), train_eval.layout(os.path.join(REPO, "results",
                                                                             "rl_r5"))
    _check(lay12 == lay_r5, f"phase 12: the driver's files {lay12} do not carry the keys of "
                            f"results/rl_r5's {lay_r5}")
    stats12 = [v for p in ev12["paired_stats"] for v in
               (p["policy_rate"], p["baseline_rate"], p["delta"], *p["delta_ci95"], p["mcnemar_z"])]
    _check(np.isfinite(stats12).all(), f"phase 12: paired statistics {ev12['paired_stats']}")
    # K2 at the env batch: in f64 against its plain version; in f32 the same
    # bits as these rows of phase 6's B=4096 launch, which is held to the f64
    # output there (a scenario's result does not depend on the batch). The
    # f32 errors of these rows alone are printed, not gated: a maximum over
    # 128 rows against the plain version's is a noisy statistic (PERF.md §6,
    # PR 11), which the 4096 rows of phase 6 steady
    lqr_rl64 = [a[:env.batch].contiguous() for a in lqr64]
    lqr_rl = [a.float() for a in lqr_rl64]
    k_rl, p_rl, w_rl = (riccati_solve_fused(*lqr_rl), riccati_solve_fused_ref(*lqr_rl),
                        riccati_solve_fused_ref(*lqr_rl64))
    rel64_rl = max(float((k - p).abs().max()) / max(1.0, float(p.abs().max()))
                   for k, p in zip(riccati_solve_fused(*lqr_rl64), w_rl))
    _check(rel64_rl <= 1e-9, f"K2 f64 at B={env.batch} vs plain f64: relative max|err| "
                             f"{rel64_rl:.3e} > 1e-9")
    _check(all(torch.equal(k, k4096[:env.batch]) for k, k4096 in zip(k_rl, k32)),
           f"K2 f32 at B={env.batch}: rows differ from the same rows of the B={B_MAIN} launch")
    e_rl = [(float((k.double() - w).abs().max()), float((p.double() - w).abs().max()))
            for k, p, w in zip(k_rl, p_rl, w_rl)]
    # the same statistic over each 128-row window of phase 6's batch
    errs = [((k.double() - w).abs().flatten(1).amax(1), (p.double() - w).abs().flatten(1).amax(1))
            for k, p, w in zip(k32, riccati_solve_fused_ref(*lqr32),
                               riccati_solve_fused_ref(*lqr64))]
    win_ok = sum(all(float(ek[r].max()) <= 2 * float(ep[r].max()) for ek, ep in errs)
                 for r in (slice(i, i + env.batch) for i in range(0, B_MAIN, env.batch)))
    k2_ms_rl = kernel_device_ms(torch, lambda: riccati_solve_fused(*lqr_rl), 20)
    k2_rl_bytes, k2_rl_ops, k2_rl_bound, k2_rl_by = k2_bound_of(lqr_rl)
    pol12, base12 = ev12["policy"], ev12["baseline_fixed_goal"]
    print(f"phase 12 RL driver (python -m doa_mpc_tpu_torch.rl.train_eval {' '.join(argv12)}): "
          f"SubgoalEnv B={env.batch} N={env.spec.n_solv} M={env.spec.n_obst} {env.scenario} "
          f"{env.opts.qp_iter} IP iters rk4 f32 k_ticks={env.k_ticks}, DDPG hidden "
          f"{agent.cfg.hidden} buffer {agent.cfg.buffer_size} batch {agent.cfg.batch_size} "
          f"act_limit {agent.cfg.act_limit}: {wall_rl:.1f} s wall, {steps_rl} env steps "
          f"({train_steps} training, {steps_rl - train_steps} evaluation; {ticks_rl} ticks) at "
          f"{np.mean(step_ms):.1f} ms/step (median {np.median(step_ms):.1f}), "
          f"{len(update_ms)} updates at {np.mean(update_ms):.2f} ms/update (median "
          f"{np.median(update_ms):.2f}); history "
          + "; ".join(f"ep {h['episode']} reward {h['reward']:.2f} reached {h['reached']:.2f}"
                      for h in hist)
          + f"; evaluation reached/hit policy {pol12['reached']:.3f}/{pol12['hit']:.3f}, "
          f"baseline {base12['reached']:.3f}/{base12['hit']:.3f}; the arms' episode-0 worlds "
          f"equal; files carry results/rl_r5's keys; K2 launches={k2_rl} (2 x "
          f"{env.opts.qp_iter} x {ticks_rl}), K1 0; buffer {bufs[0].size} rows | K2 f32 at "
          f"B={env.batch} max|err| vs f64 kernel/plain "
          + ", ".join(f"{ek:.2e}/{ep:.2e}" for ek, ep in e_rl)
          + f" (not gated; kernel within 2x plain f32 in {win_ok} of the {B_MAIN // env.batch} "
          f"{env.batch}-row windows of phase 6's batch), rows equal to phase 6's B={B_MAIN} "
          f"rows; f64 rel max|err| {rel64_rl:.3e} (limit 1e-9); device time {k2_ms_rl:.4f} ms "
          f"(CUDA events behind a spin, 20 launches), bound "
          f"{k2_rl_bound:.6f} ms ({k2_rl_by}: {k2_rl_bytes} B, {k2_rl_ops} operations); "
          f"card={card}; wall {lap():.1f} s", flush=True)

    # ---- phase 13: the rk4 seed-matched legs through K1 -------------------------
    # prod_rk4_qp6 (the forecast typo kept) and prod_fixedbug (fixed): rk4,
    # fused, 6 IP iterations, status-4 off, f32, each cell's own TF, N, M and
    # initial guess. At one IP budget the legs' cells differ only in TF,
    # initial guess and scenario, so each leg is 3 runs of a RANDOM/EDGE pair
    out13 = os.path.join(OUT_DIR, "phase13")
    legs13, lines13, runs13 = {}, [], []
    for name in ("prod_rk4_qp6", "prod_fixedbug"):
        leg = leg_prod if name == "prod_rk4_qp6" else parity.load_leg(
            os.path.join(PARITY_R5, name))
        s13 = parity.leg_settings(leg)
        _check((s13.backend, s13.integrator, s13.qp_iter_override, s13.status4, s13.f64,
                s13.fix_pred_bug) == ("fused", "rk4", QP_ITER, False, False,
                                      name == "prod_fixedbug"),
               f"results/parity_r5/{name} is not the rk4 fused f32 leg: {s13}")
        res13, r13 = replay_counted(parity, kernels, leg, s13, leg.cells, dev)
        stats13, legs13[name] = check_replay(f"phase 13 {name}", parity, res13, r13,
                                             (400, 0, 0), leg_bound=0.04)
        parity.summarize(leg, s13, res13, os.path.join(out13, name), card)
        lines13 += [f"{name} {cell_line(st)}" for st in stats13]
        runs13 += [dict(r, cells=[f"{name} {c}" for c in r["cells"]]) for r in r13]
        if name == "prod_rk4_qp6":
            same13 = int((res13[0].rows == data).all(1).sum())
            _check(res13[0].cell is cell4[0], "phase 13: the first cell is not phase 4's")
    print(f"phase 13 rk4 seed-matched legs (sim/parity.py: fused, 6 IP iters, status-4 off, f32, "
          f"100 seeds x 400 ticks per cell, K1 launches 400 per run; {len(runs13)} runs for "
          f"{len(lines13)} cells): " + "; ".join(lines13) + f" (H100/TPU CSV) | runs: "
          f"{runs_line(runs13)} | " + "; ".join(leg_line(n, a) for n, a in legs13.items())
          + f" | prod_rk4_qp6 20221031_215846_RANDOM: {same13} of {len(data)} rows equal to "
          f"phase 4's run of it alone; card={card}; wall {lap():.1f} s", flush=True)

    # ---- phase 14: sharded campaigns through K1 ---------------------------------
    # the production campaign cell (TF 2.0, N 20, M 5, 6 IP iterations, rk4,
    # fused, f32, RANDOM, 100 seeds x 400 ticks, seed 0): (a) in process over
    # a one-card mesh and unsharded, (b) the experiment command as two
    # processes of a gloo group, both on cuda:0 with 50 rows each, (c) (b)
    # with IRK against the unsharded IRK run
    spec14 = WorldSpec(tf=2.0, n_solv=N, n_obst=M, qp_iter=QP_ITER)
    opts14 = SolverOptions(qp_iter=QP_ITER, integrator="rk4")
    sharded_rollout, stats14, runs14 = pmesh.make_sharded_rollout, [], {}

    def recording_rollout(*a, **k):
        """``make_sharded_rollout`` whose runs record their statistics."""
        fn = sharded_rollout(*a, **k)

        def run(shards):
            final, stats = fn(shards)
            stats14.append(stats)
            return final, stats

        return run

    mesh14 = pmesh.make_data_mesh()
    pmesh.make_sharded_rollout = recording_rollout
    try:
        for name, mesh_ in (("mesh", mesh14), ("unsharded", None)):
            solve_ocp_qp_fused.launches = riccati_solve_fused.launches = 0
            t0 = time.time()
            d = run_scenario_batch(spec14, opts14, "RANDOM", n_runs=100, max_iter=400,
                                   dtype=torch.float32, backend="fused", mesh=mesh_, device=dev)
            runs14[name] = (d, solve_ocp_qp_fused.launches, riccati_solve_fused.launches,
                            time.time() - t0)
    finally:
        pmesh.make_sharded_rollout = sharded_rollout
    d14, d_ref = runs14["mesh"][0], runs14["unsharded"][0]
    for name, (d, k1, k2, _) in runs14.items():
        _check(k1 == 400 and k2 == 0, f"phase 14 {name}: K1 launched {k1} times (K2 {k2}) "
                                      f"in 400 ticks")
        _check(d.shape == (100, 6) and np.isfinite(d).all(), f"phase 14 {name}: rows {d.shape}")
    _check(np.array_equal(d14, d_ref), "phase 14: the mesh rows differ from the unsharded rows "
                                       f"in {int((d14 != d_ref).any(1).sum())} of 100")
    (st14,) = stats14
    want14 = dict(n=100.0, reached=d14[:, 1].sum(), hit=d14[:, 0].sum(), oob=d14[:, 5].sum(),
                  steps_sum=d14[:, 4].sum(), min_margin=d14[:, 2].min())
    _check(st14 == want14, f"phase 14: stats {st14} are not the rows' sums and min {want14}")
    launches14 = runs14["mesh"][1]

    def two_ranks(integrator):
        """The experiment command as two gloo ranks on cuda:0, 50 rows each:
        (its rows, wall s)."""
        out = os.path.join(OUT_DIR, f"phase14_{integrator}")
        shutil.rmtree(out, ignore_errors=True)
        port = free_port()
        cmd = [sys.executable, "-m", "doa_mpc_tpu_torch", "experiment", "--distributed",
               "--device", "cuda", "--runs", "100", "--max-iter", "400", "--qp-iter",
               str(QP_ITER), "--integrator", integrator, "--scenarios", "RANDOM", "--out", out]
        t0 = time.time()
        procs = [subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True,
                                  env=dict(os.environ, MASTER_ADDR="localhost",
                                           MASTER_PORT=str(port), WORLD_SIZE="2", RANK=str(r),
                                           LOCAL_RANK=str(r)))
                 for r in range(2)]
        try:
            outs = [p.communicate(timeout=300)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.time() - t0
        for r, (p, o) in enumerate(zip(procs, outs)):
            with open(os.path.join(OUT_DIR, f"phase14_{integrator}_rank{r}.log"), "w") as f:
                f.write(o)
            _check(p.returncode == 0,
                   f"phase 14 {integrator} rank {r} exited {p.returncode}:\n{o[-3000:]}")
        files = sorted(os.listdir(out))
        _check(len(files) == 2 and files[0].endswith("_experiment_data.csv")
               and files[1].endswith("_experiment_spec.json"),
               f"phase 14 {integrator}: the two ranks wrote {files}, expected one CSV/JSON pair")
        summaries = [sum("collision=" in ln for ln in o.splitlines()) for o in outs]
        _check(summaries == [1, 0],
               f"phase 14 {integrator}: summary lines per rank {summaries}, expected [1, 0]")
        rows = np.loadtxt(os.path.join(out, files[0]), delimiter=";")
        _check(rows.shape == (100, 6) and np.isfinite(rows).all(),
               f"phase 14 {integrator}: 2-rank rows {rows.shape}")
        return rows, wall

    d2, wall14b = two_ranks("rk4")
    hit2, reached2 = d2[:, 0].mean(), d2[:, 1].mean()
    hit1, reached1 = d_ref[:, 0].mean(), d_ref[:, 1].mean()
    _check(abs(hit2 - hit1) <= 0.10 and abs(reached2 - reached1) <= 0.10,
           f"phase 14: 2 ranks hit {hit2} reached {reached2} against {hit1} {reached1} unsharded")
    same_rows = int((d2 == d_ref).all(1).sum())
    # (c) the same cell with IRK (the default integrator): unsharded, then as
    # two ranks, whose rows must be the unsharded rows
    solve_ocp_qp_fused.launches = irk_step_fused.launches = 0
    t0 = time.time()
    d_irk = run_scenario_batch(spec14, SolverOptions(qp_iter=QP_ITER, integrator="irk"),
                               "RANDOM", n_runs=100, max_iter=400, dtype=torch.float32,
                               backend="fused", device=dev)
    wall14c, k14c = time.time() - t0, (solve_ocp_qp_fused.launches, irk_step_fused.launches)
    _check(k14c == (400, 400 * K3_PER_TICK), f"phase 14 IRK unsharded: K1, K3 launches {k14c}")
    d2_irk, wall14d = two_ranks("irk")
    same_irk = int((d2_irk == d_irk).all(1).sum())
    _check(same_irk == 100, f"phase 14: the 2-rank IRK rows equal the unsharded rows in "
                            f"{same_irk} of 100")
    print(f"phase 14 sharded campaigns (TF 2.0, N={N}, M={M}, {QP_ITER} IP iters, rk4, fused, "
          f"f32, RANDOM, 100 seeds x 400 ticks, seed 0): (a) one-card mesh "
          f"{runs14['mesh'][3]:.1f} s, unsharded {runs14['unsharded'][3]:.1f} s; rows identical "
          f"(6 columns, 100 rows); K1 launches {runs14['mesh'][1]} / {runs14['unsharded'][1]}; "
          f"stats = row sums and min: n {st14['n']:.0f} hit {st14['hit']:.0f} reached "
          f"{st14['reached']:.0f} oob {st14['oob']:.0f} steps {st14['steps_sum']:.0f} "
          f"min_margin {st14['min_margin']:.4f} | (b) `experiment --distributed` as 2 gloo "
          f"ranks on cuda:0, 50 rows each: {wall14b:.1f} s wall (processes started to both "
          f"exited); one CSV/JSON pair and one summary, from rank 0; hit {hit2:.2f} reached "
          f"{reached2:.2f} against {hit1:.2f} {reached1:.2f} unsharded; rows identical to the "
          f"unsharded run: {same_rows} of 100, per-seed agreement hit "
          f"{(d2[:, 0] == d_ref[:, 0]).mean():.2f} reached {(d2[:, 1] == d_ref[:, 1]).mean():.2f}"
          f" | (c) IRK: unsharded {wall14c:.1f} s (K1 {k14c[0]}, K3 {k14c[1]} launches), hit "
          f"{d_irk[:, 0].mean():.2f} reached {d_irk[:, 1].mean():.2f}; 2 gloo ranks "
          f"{wall14d:.1f} s, rows identical to the unsharded IRK run: {same_irk} of 100 (gate: "
          f"all); card={card}; wall {lap():.1f} s", flush=True)

    # ---- phase 15: the status-4 analogue with the plant brake through K1 ----
    # the v0_baseline pair 20221031_215846 RANDOM + 20221031_220136 EDGE as one
    # batch: IRK, fused, f32, status-4 armed with the brake, 100 IP
    # iterations, TF 2, N 20, M 5, 200 rows x 400 ticks
    leg15 = parity.load_leg(os.path.join(PARITY_R5, "v0_baseline"))
    s15 = parity.leg_settings(leg15)
    _check((s15.integrator, s15.backend, s15.status4, s15.f64) == ("irk", "fused", True, False),
           f"results/parity_r5/v0_baseline is not the IRK fused f32 status-4 leg: {s15}")
    cells15 = [c for c in leg15.cells if c["stamp"] in ("20221031_215846", "20221031_220136")]
    res15, runs15 = replay_counted(parity, kernels, leg15, s15, cells15, dev)
    _check(len(runs15) == 1 and runs15[0]["rows"] == 200,
           f"phase 15: {len(runs15)} runs, expected one batch of 200 rows")
    stats15, _ = check_replay("phase 15", parity, res15, runs15, (400, 0, 400 * K3_PER_TICK))
    for st in stats15:
        _check(0 < st["resets_mean"] and 0.5 * st["tpu_resets_mean"] <= st["resets_mean"]
               <= 2 * st["tpu_resets_mean"],
               f"phase 15 {st['stamp']}_{st['scenario']}: {st['resets_mean']} status-4 resets per "
               f"run, the TPU CSV {st['tpu_resets_mean']} (0.5x-2x)")
    parity.summarize(leg15, s15, res15, os.path.join(OUT_DIR, "phase15"), card)
    print(f"phase 15 status-4 analogue with the plant brake (v0_baseline through sim/parity.py: "
          f"fused, IRK, f32, {cells15[0]['qp_iter']} IP iters, fail mu < {s15.fail_mu:g} and stat "
          f"< {s15.fail_stat:g}; one batch of {runs15[0]['rows']} rows x {s15.max_iter} ticks in "
          f"{runs15[0]['wall_s']:.1f} s, K1 launches {runs15[0]['launches'][0]}, K2 "
          f"{runs15[0]['launches'][1]}, K3 {runs15[0]['launches'][2]}): "
          + "; ".join(f"{cell_line(st)} resets per run {st['resets_mean']:.2f} (TPU CSV "
                      f"{st['tpu_resets_mean']:.2f}, max {st['resets_max']})" for st in stats15)
          + f" (H100/TPU CSV); card={card}; wall {lap():.1f} s", flush=True)

    # ---- phase 16: the f64 IRK riccati tick (K2's f64 entry) against the CPU --
    # the f64_nostatus4 leg's settings (IRK, f64, status-4 off, 100 IP
    # iterations) through the riccati backend: cell 20221031_215846's first 8
    # seeds, 4 ticks, on the card (K2's plain version and the plain Riccati
    # sweep forbidden) and on the CPU
    leg16 = parity.load_leg(os.path.join(PARITY_R5, "f64_nostatus4"))
    s16 = parity.leg_settings(leg16, backend="riccati", seeds=8, max_iter=4)
    cell16 = parity.select(leg16.cells, "215846")
    _check((s16.integrator, s16.f64, s16.status4, cell16[0]["qp_iter"]) == ("irk", True, False, 100),
           f"results/parity_r5/f64_nostatus4 is not the IRK f64 leg at 100 IP iterations: {s16}")
    runs16 = {}
    for where in (dev, torch.device("cpu")):
        solve_ocp_qp_fused.launches = riccati_solve_fused.launches = 0
        irk_step_fused.launches = 0
        with (plain_forbidden(ip_qp, riccati_fused) if where.type == "cuda"
              else contextlib.nullcontext()):
            rows16, fin16, wall16 = parity.run_group(cell16, s16, s16.seeds, where)
        runs16[where.type] = (rows16["RANDOM"], fin16.x0.cpu(), riccati_solve_fused.launches,
                              solve_ocp_qp_fused.launches, irk_step_fused.launches, wall16)
    want16 = s16.max_iter * cell16[0]["qp_iter"] * 2
    want16_k3 = s16.max_iter * K3_PER_TICK
    _check(runs16["cuda"][2:5] == (want16, 0, want16_k3) and runs16["cpu"][2:5] == (0, 0, 0),
           f"phase 16: K2, K1, K3 launches {runs16['cuda'][2:5]} on the card (expected "
           f"{want16}, 0, {want16_k3}), {runs16['cpu'][2:5]} on the CPU")
    _check(runs16["cuda"][1].dtype == torch.float64, "phase 16: the card's run is not f64")
    err16 = float((runs16["cuda"][1] - runs16["cpu"][1]).abs().max())
    _check(err16 <= 1e-7, f"phase 16: card vs CPU x0 max|err| {err16:.3e} > 1e-7")
    rows_err16 = float(np.abs(runs16["cuda"][0] - runs16["cpu"][0]).max())
    print(f"phase 16 f64 IRK riccati tick (f64_nostatus4's settings, backend riccati, cell "
          f"20221031_215846, {s16.seeds} seeds, {cell16[0]['qp_iter']} IP iters, "
          f"{s16.max_iter} ticks): card vs CPU x0 max|err|={err16:.3e} (limit 1e-7), metric rows "
          f"max|err|={rows_err16:.3e}; {runs16['cuda'][5]:.2f} s on the card ({runs16['cuda'][2]} "
          f"K2 f64 launches = {s16.max_iter} x {cell16[0]['qp_iter']} x 2, no plain Riccati "
          f"solve; {runs16['cuda'][4]} K3 f64 launches), {runs16['cpu'][5]:.2f} s on the CPU; "
          f"card={card}; wall {lap():.1f} s",
          flush=True)

    # bounds: each input byte read once and each output byte written once; the
    # operations the outputs need, counted from each kernel's own code on the
    # inputs it was timed on
    t0 = time.time()
    k1_ops = opc.ip_solve(captured[30], QP_ITER, uni)
    count_s = time.time() - t0
    k1_bytes = fused_hbm_bytes(spec, B_MAIN)
    k1_bound, k1_by = bound(k1_bytes, k1_ops)
    k1_ops_1 = opc.ip_solve(qp1, QP_ITER, uni)
    k1_bytes_1 = fused_hbm_bytes(spec, 1)
    k1_bound_1, k1_by_1 = bound(k1_bytes_1, k1_ops_1)
    k2_bytes, k2_ops, k2_bound, k2_by = k2_bound_of(lqr32)
    k2_bytes_1, k2_ops_1, k2_bound_1, k2_by_1 = k2_bound_of(lqr32_1)
    print(f"bounds: K1 unicycle B={B_MAIN} {k1_bytes} B and {k1_ops} operations "
          f"-> {k1_bound:.5f} ms ({k1_by}), B=1 {k1_bytes_1} B and {k1_ops_1} operations -> "
          f"{k1_bound_1:.7f} ms ({k1_by_1}); K2 B={B_MAIN} {k2_bytes} B and {k2_ops} operations "
          f"-> {k2_bound:.5f} ms ({k2_by}), B=1 {k2_bytes_1} B and {k2_ops_1} operations -> "
          f"{k2_bound_1:.7f} ms ({k2_by_1}), B={len(lqr_rl[0])} {k2_rl_bytes} B and {k2_rl_ops} "
          f"operations -> {k2_rl_bound:.7f} ms ({k2_rl_by}); against {HBM_BYTES_PER_S:.3g} B/s and "
          f"{F32_OPS_PER_S:.3g} f32 op/s (K1 counted in {count_s:.1f} s); card={card}; "
          f"wall {lap():.1f} s; phases {time.time() - START:.1f} s in all",
          flush=True)

    kernels = [{"name": "ip_solve_kernel<Unicycle>", "route": "cuda",
                "source": "doa_mpc_tpu_torch/csrc/ip_solve.cu",
                "replaces": "doa_mpc_tpu/ops/ip_pallas.py:413",
                "launches": launches14, "max_abs_err": max(max_err_1.values()),
                "ms": k1_ms, "plain_ms": plain_ms, "bound_ms": k1_bound, "bound_by": k1_by,
                "library_ms": None},
               {"name": "riccati_f32 (rti_step: the demo rollout)", "route": "cuda",
                "source": "doa_mpc_tpu_torch/csrc/riccati.cu",
                "replaces": "doa_mpc_tpu/ops/riccati_pallas.py:104",
                "launches": k2_demo, "max_abs_err": k2_err,
                "ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_bound, "bound_by": k2_by,
                "library_ms": None},
               {"name": "irk_step_kernel (K3, the whole IRK step; every launch of the IRK "
                        "path counted, timed at the linearization's step: f32, s=4, 3 Newton "
                        "iterations, with D, B*N = 81,920 rows)", "route": "cuda",
                "source": "doa_mpc_tpu_torch/csrc/irk_step.cu",
                "replaces": "doa_mpc_tpu/ops/integrators.py:107",
                "launches": runs9a[0]["launches"][2], "max_abs_err": k3_err,
                "ms": k3_times["lin"]["ms"], "plain_ms": k3_times["lin"]["plain_ms"],
                "bound_ms": k3_times["lin"]["bound_ms"], "bound_by": k3_times["lin"]["bound_by"],
                "library_ms": None}]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
