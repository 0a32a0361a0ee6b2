#!/usr/bin/env python3
"""Bring-up check of the PyTorch port (``doa_mpc_tpu_torch``) on one GPU.

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds kernel K1 (``doa_mpc_tpu_torch/csrc/ip_solve.cu``) with nvcc for
sm_90a, holds it against its plain PyTorch version on real QPs, drives the
main path (the seed-matched Monte-Carlo cell ``20221031_215846``: RANDOM,
TF 2.0, N 20, M 5, 100 seeds x 400 ticks, rk4, 6 IP iterations, f32),
times the control tick at B=4096 and B=1, and prints one line per phase.
The line before the last is a JSON object describing each kernel; the last
line is ``{"ok": true, "device": {...}}``. Any failed check raises, so the
script exits non-zero and prints no result; it also does so without CUDA or
outside a checkout of the repository. Long diagnostics go to
``chiprun_out/chip_smoke/``.
"""

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "chiprun_out", "chip_smoke")
PARITY_CSV = os.path.join(REPO, "results", "parity_r5", "prod_rk4_qp6",
                          "20221031_215846_RANDOM_ours.csv")
HARD_QPS = os.path.join(REPO, "tests", "fixtures", "hard_qps_f32.npz")
B_MAIN, N, M, QP_ITER = 4096, 20, 5, 6
CAPTURE_TICKS = (0, 10, 30)


def _die(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def _check(cond, msg):
    if not cond:
        _die(msg)


def _card():
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def _time_ms(torch, fn, reps, warmup=1):
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


def main():
    try:
        import torch
    except ImportError:
        _die("torch is not installed")
    if not torch.cuda.is_available():
        _die("torch.cuda.is_available() is False: this check needs an NVIDIA GPU")
    if not os.path.isfile(os.path.join(REPO, "doa_mpc_tpu_torch", "csrc", "ip_solve.cu")):
        _die("run from the root of a checkout: doa_mpc_tpu_torch/ is missing")
    sys.path.insert(0, REPO)
    os.makedirs(OUT_DIR, exist_ok=True)

    import numpy as np
    from doa_mpc_tpu_torch.config import SolverOptions, WorldSpec, default_cost_params
    from doa_mpc_tpu_torch.ops import ip_fused
    from doa_mpc_tpu_torch.ops.ip_fused import solve_ocp_qp_fused, solve_ocp_qp_fused_ref
    from doa_mpc_tpu_torch.ops.ocp_qp import OcpQp
    from doa_mpc_tpu_torch.sim.closed_loop import init_loop_state, make_batched_tick
    from doa_mpc_tpu_torch.sim.compat_rng import mt_experiment_batch
    from doa_mpc_tpu_torch.sim.experiments import run_scenario_batch
    from doa_mpc_tpu_torch.sim.obstacles import predict_trajectory, robot_start_goal
    from doa_mpc_tpu_torch.solver.sqp_rti import make_rti_controller

    dev = torch.device("cuda", 0)
    card = _card()

    # ---- phase 1: device -------------------------------------------------
    nvcc_v = subprocess.run([ip_fused._nvcc(), "--version"], capture_output=True,
                            text=True, check=True).stdout.strip().splitlines()[-1]
    print(f"phase 1 device: card={card} torch={torch.__version__} "
          f"cuda={torch.version.cuda} nvcc={nvcc_v!r}", flush=True)

    # ---- phase 2: build --------------------------------------------------
    t0 = time.time()
    lib_path = ip_fused.build_kernel()
    ip_fused._library()
    build_s = time.time() - t0
    with open(lib_path[:-3] + ".log") as f:
        ptxas = [ln.strip() for ln in f if "registers" in ln or "spill" in ln]
    print(f"phase 2 build: {build_s:.2f} s -> {os.path.relpath(lib_path, REPO)}; "
          f"ptxas: {' | '.join(ptxas)}", flush=True)

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

    max_err_1 = 0.0
    rows = {}
    for t, qp in captured.items():
        k1 = solve_ocp_qp_fused(qp, iters=1)
        p1 = solve_ocp_qp_fused_ref(qp, iters=1)
        torch.cuda.synchronize()
        err = max(float((getattr(k1, f) - getattr(p1, f)).abs().max()) for f in ("dx", "du", "s"))
        _check(np.isfinite(err) and err <= 5e-4,
               f"tick {t}: kernel vs plain after 1 iteration differs by {err} > 5e-4")
        max_err_1 = max(max_err_1, err)
        # the oracle is the converged f64 solve (80 iterations), as in
        # scripts/tpu_equiv_check.py
        du_ref = solve_ocp_qp_fused_ref(OcpQp(*[a.double() for a in qp]), iters=80).du
        for iters in (QP_ITER, 50):
            e_k = (solve_ocp_qp_fused(qp, iters=iters).du.double() - du_ref).abs().amax((1, 2))
            e_p = (solve_ocp_qp_fused_ref(qp, iters=iters).du.double() - du_ref).abs().amax((1, 2))
            q = torch.tensor([0.5, 0.95], dtype=torch.float64, device=dev)
            (mk, pk), (mp, pp) = torch.quantile(e_k, q).tolist(), torch.quantile(e_p, q).tolist()
            ok = mk <= max(2 * mp, 1e-3) and pk <= max(2 * pp, 1e-2)
            rows[f"tick{t}_it{iters}"] = dict(kernel_med=mk, kernel_p95=pk,
                                              plain_med=mp, plain_p95=pp, ok=ok)
            _check(ok, f"tick {t}, {iters} iterations: f64 arbitration failed "
                       f"(kernel med {mk:.3g} p95 {pk:.3g}; plain-f32 med {mp:.3g} p95 {pp:.3g})")
    hard = np.load(HARD_QPS)
    hqp = OcpQp(*[torch.as_tensor(hard[f], device=dev) for f in OcpQp._fields])
    hsol = solve_ocp_qp_fused(hqp, iters=int(hard["iters"]))
    _check(all(bool(torch.isfinite(a).all()) for a in hsol), "hard_qps_f32.npz: non-finite")
    with open(os.path.join(OUT_DIR, "phase3_arbitration.json"), "w") as f:
        json.dump(rows, f, indent=1)
    print(f"phase 3 kernel-vs-plain: B={B_MAIN} N={N} M={M} ticks {list(CAPTURE_TICKS)}: "
          f"1-iter max|err|={max_err_1:.3e} (atol 5e-4); du vs converged-f64 oracle ok at "
          f"{QP_ITER} and 50 iterations: "
          + "; ".join(f"{k} k_med={v['kernel_med']:.2e} p_med={v['plain_med']:.2e}"
                      for k, v in rows.items())
          + f"; hard_qps finite; card={card}", flush=True)

    # ---- phase 4: main path, seed-matched cell 20221031_215846 -------------
    ref = np.loadtxt(PARITY_CSV, delimiter=";")
    n_runs, max_iter = ref.shape[0], 400
    solve_ocp_qp_fused.launches = 0
    t0 = time.time()
    data = run_scenario_batch(spec, opts, "RANDOM", n_runs=n_runs, max_iter=max_iter,
                              dtype=torch.float32, backend="fused", compat_rng=True,
                              device=dev)
    wall = time.time() - t0
    launches = solve_ocp_qp_fused.launches
    _check(launches == max_iter, f"K1 launched {launches} times in {max_iter} ticks")
    _check(data.shape == (n_runs, 6) and np.isfinite(data).all(), "non-finite metric rows")
    np.savetxt(os.path.join(OUT_DIR, "20221031_215846_RANDOM_h100.csv"), data, delimiter=";")
    hit, reached = data[:, 0].mean(), data[:, 1].mean()
    ref_hit, ref_reached = ref[:, 0].mean(), ref[:, 1].mean()
    agree_hit = (data[:, 0] == ref[:, 0]).mean()
    agree_reached = (data[:, 1] == ref[:, 1]).mean()
    _check(abs(hit - ref_hit) <= 0.10 and abs(reached - ref_reached) <= 0.10,
           f"rates off the TPU f32 run: hit {hit} vs {ref_hit}, reached {reached} vs {ref_reached}")
    print(f"phase 4 main path: {n_runs} seeds x {max_iter} ticks in {wall:.1f} s wall; "
          f"hit={hit:.2f} (TPU CSV {ref_hit:.2f}) reached={reached:.2f} "
          f"(TPU CSV {ref_reached:.2f}); per-seed agreement hit={agree_hit:.2f} "
          f"reached={agree_reached:.2f}; K1 launches={launches}; card={card}", flush=True)

    # ---- phase 5: throughput ------------------------------------------------
    def tick_ms(batch, backend):
        gen = torch.Generator(device=dev).manual_seed(0)
        tk = make_batched_tick(ctrl, goal, params, backend=backend, generator=gen)
        state = [init_loop_state(ctrl, start, goal, batch_shape=(batch,), generator=gen)]

        def step():
            state[0] = tk(state[0])

        return _time_ms(torch, step, reps=200, warmup=20)

    ms_4096 = tick_ms(B_MAIN, "fused")
    ms_zero = tick_ms(B_MAIN, "zero")
    ms_1 = tick_ms(1, "fused")
    ms_zero_1 = tick_ms(1, "zero")
    qp = captured[30]
    k1_ms = _time_ms(torch, lambda: solve_ocp_qp_fused(qp, iters=QP_ITER), reps=20, warmup=2)
    plain_ms = _time_ms(torch, lambda: solve_ocp_qp_fused_ref(qp, iters=QP_ITER), reps=3, warmup=1)
    qp1 = OcpQp(*[a[:1].contiguous() for a in qp])
    k1_ms_1 = _time_ms(torch, lambda: solve_ocp_qp_fused(qp1, iters=QP_ITER), reps=20, warmup=2)
    mem = torch.cuda.max_memory_allocated() / 2**20
    print(f"phase 5 throughput: B={B_MAIN} tick {ms_4096:.4f} ms = "
          f"{B_MAIN / ms_4096 * 1e3:.0f} solves/s; glue-only (zero backend) tick "
          f"{ms_zero:.4f} ms; K1 {k1_ms:.4f} ms/launch; plain version {plain_ms:.3f} "
          f"ms/solve (N={N}, M={M}, {QP_ITER} iters, f32) | B=1 tick {ms_1:.4f} ms; "
          f"glue-only {ms_zero_1:.4f} ms; K1 {k1_ms_1:.4f} ms/launch | "
          f"peak mem {mem:.0f} MiB; card={card}", flush=True)

    kernels = [{"name": "ip_solve_f32", "route": "cuda",
                "source": "doa_mpc_tpu_torch/csrc/ip_solve.cu",
                "replaces": "doa_mpc_tpu/ops/ip_pallas.py:413",
                "launches": launches, "max_abs_err": max_err_1,
                "ms": k1_ms, "plain_ms": plain_ms}]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
