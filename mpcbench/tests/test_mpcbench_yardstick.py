"""The yardstick against the program's own arithmetic as it stands: the
frozen operation counter counts what ``ops/op_count.py`` counts on a small
seeded QP, IRK step and LQR, and the bytes from shapes are the program's;
the trace's reduction (busy time, idle share, kernels, rooflines) on a
made-up trace."""

import math

import torch

from common import BENCH
from mpcbench import harness, trace, yardstick
from mpcbench.reference import ip as ref_ip, tick as ref_tick


def _seeded_qp(rows=3, n=6, m=2, seed=0):
    """A tick's QP at a small size, built by the reference from seeded
    states and worlds (float64)."""
    _, config, _, _ = harness.cell_files(BENCH, "campaign_irk_qp100.pair200")
    world = dict(config["world"], n_solv=n, n_obst=m)
    g = torch.Generator().manual_seed(seed)
    x0 = torch.tensor([-7.0, -7.0, 0.78, 0.5, 0.1], dtype=torch.float64).repeat(rows, 1)
    x0[:, :2] += torch.rand(rows, 2, generator=g, dtype=torch.float64)
    st = dict(x0=x0, x_traj=x0[:, None].repeat(1, n + 1, 1)
              + 0.1 * torch.rand(rows, n + 1, 5, generator=g, dtype=torch.float64),
              u_traj=0.3 * torch.rand(rows, n, 2, generator=g, dtype=torch.float64))
    pos = -3.0 + 6.0 * torch.rand(rows, m, 2, generator=g, dtype=torch.float64)
    vel = torch.rand(rows, m, 2, generator=g, dtype=torch.float64)
    pred = ref_tick.forecast(pos, vel, world, n, True)
    params = {k: torch.tensor(v, dtype=torch.float64) for k, v in config["cost"].items()}
    return ref_tick.build_qp(st, torch.tensor(config["goal"], dtype=torch.float64), pred,
                             params, world, config["solver"])


def test_frozen_counter_counts_what_the_program_counts(tmp_path):
    from doa_mpc_tpu_torch.ops.ip_fused import UNICYCLE_QP_STRUCTURE
    from doa_mpc_tpu_torch.ops.ocp_qp import OcpQp
    from doa_mpc_tpu_torch.ops.op_count import OpCounter

    prog, frozen = OpCounter(out_dir=str(tmp_path)), yardstick.OpCounter()
    qp = _seeded_qp()
    normed = ref_ip.normalize(qp)
    want = prog.ip_solve(OcpQp(*qp), iters=5, structure=UNICYCLE_QP_STRUCTURE)
    got = frozen.k1({k: getattr(normed, k).numpy() for k in normed._fields}, 5)
    assert got == want > 0
    assert frozen.k2(20) == prog.riccati(20) > 0
    for sens in (False, True):
        assert frozen.k3(7, 4, 3, sens) == prog.irk_step(7, 4, 3, 1, sens) > 0


def test_bytes_from_shapes_are_the_programs():
    from doa_mpc_tpu_torch.config import WorldSpec
    from doa_mpc_tpu_torch.utils.profiling import fused_hbm_bytes, irk_step_bytes

    for b, n, m in ((200, 20, 5), (4096, 20, 5), (100, 30, 30)):
        assert yardstick.k1_bytes(b, n, m) == fused_hbm_bytes(WorldSpec(n_solv=n, n_obst=m), b)
    for rows, sens in ((81920, True), (4096, False)):
        assert yardstick.k3_bytes(rows, 4, sens) == irk_step_bytes(rows, 4, sens, 4)


def test_trace_reduction():
    _, config, _, _ = harness.cell_files(BENCH, "campaign_irk_qp100.pair200")
    lin = "void irk_step_kernel<float, 4, true>(irks::Params<float>)"
    plant = "void irk_step_kernel<float, 4, false>(irks::Params<float>)"
    ops = [(lin, 0.0, 30.0),
           ("Memcpy HtoD (Pageable -> Device)", 10.0, 5.0),
           (plant, 100.0, 30.0),
           ("elementwise_kernel", 500.0, 40.0)]
    host = [("aten::cat", 120.0, 400.0), ("aten::add", 200.0, 10.0)]
    tr = trace.Trace(ops, host, ticks=2, window_s=1e-3, config=config, rows=3, qp_input=None)
    assert math.isclose(tr.busy_s(), 100e-6)
    assert math.isclose(tr.idle_pct(), 90.0)
    assert tr.kernels_per_tick() == 1.5
    assert math.isclose(tr.ms_per_tick("k3"), 0.03)
    assert tr.ms_per_tick("k1") is None and tr.roofline_pct("k1") is None
    s, it = config["solver"]["irk_stages"], config["solver"]["irk_newton_iter"]
    n = config["world"]["n_solv"]
    per = (yardstick.bound_s(yardstick.k3_bytes(3 * n, s, True),
                             tr.counter().k3(3 * n, s, it, True))
           + yardstick.bound_s(yardstick.k3_bytes(3, s, False), tr.counter().k3(3, s, it, False)))
    assert math.isclose(tr.roofline_pct("k3"), 100.0 * per / 60e-6)
    bd = tr.breakdown()
    assert bd["device_ops"][0] == ["elementwise_kernel", 40e-6]
    assert {n for n, _ in bd["device_ops"][1:3]} == {lin, plant}
    assert bd["idle_gaps"][0][0] == "aten::cat" and math.isclose(bd["idle_gaps"][0][1], 370e-6)
    assert bd["idle_gaps"][1][0] == "(no host op)" and math.isclose(bd["idle_gaps"][1][1], 70e-6)
    for m in BENCH["per_layer"]:
        v = harness.reader(m["name"])(tr)
        assert v is None or v > 0
