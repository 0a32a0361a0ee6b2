"""The benchmark's production controller (``mpcbench/configs/
prod_fixedbug_rk4_qp6.json``: rk4, 6 IP iterations, the forecast fixed,
``fused``) run through the port's batched tick, held tick by tick to the
benchmark's plain reference (``mpcbench/reference/tick.py``) on the CPU in
float64.

As the benchmark's check does on the card, the reference runs each tick on
the loop state the port's tick received, with the same obstacle noise, and
the two are compared in state, plan, world and metrics; the fresh batch is
compared by itself. On CPU tensors ``fused`` runs K1's plain version.
"""

import copy
import os

import pytest
import torch

from doa_mpc_tpu_torch.ops import ip_fused
from mpcbench import check, generator, harness, system

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "BENCHMARK.json")
CELL = "prod_fixedbug_rk4_qp6.b131072"
TICKS = 5
SEED = 2**31 + 4242
# Both sides compute the same formulas in float64 with the same constants,
# but not always in the same order: a sum taken in another order moves the
# last bits (1e-16 relative), and six IP iterations on QPs whose slack
# weights reach 1e4 may carry that to 1e-12 (the gaps read 0.0 on these
# rows). The planted fault moves the plan by 0.05, eight orders above.
TOL = {"start": 1e-10, "world": 1e-10, "state": 1e-10, "plan": 1e-10, "metric": 1e-10}


@pytest.fixture
def sweep(monkeypatch):
    """The cell's configuration in float64 with 4 RANDOM and 4 EDGE rows.
    The reference takes the float32 constants the configuration's precision
    states (tolerances, regularization, sigma's cap) whatever dtype it
    computes in; the port's K1 takes its dtype's, so it is given the float32
    ones here, as it has on the card."""
    _, config, mix, _ = harness.cell_files(harness.load_json(BENCH), CELL)
    assert (config["solver"]["integrator"], config["solver"]["qp_iter"],
            config["solver"]["compat_pred_bug"], config["backend"]) == ("rk4", 6, False, "fused")
    config = dict(copy.deepcopy(config), dtype="float64")
    mix = dict(mix, scenarios={"RANDOM": 4, "EDGE": 4})
    f32 = ip_fused._constants
    monkeypatch.setattr(ip_fused, "_constants",
                        lambda dtype, reg, tol: f32(torch.float32, reg, tol))
    return config, mix


def _rows_off(config, mix):
    """Per compared tick (the fresh batch first), the rows whose gap to the
    reference passes a tolerance."""
    dev = torch.device("cpu")
    sysm = system.System(config, dev, random_move=mix["noise"])
    traffic = generator.Traffic(mix, config, SEED, dev)
    case = check.Case(config, dev)
    pos, vel = traffic.worlds()
    st = sysm.init(pos, vel)
    start = check.start_gap(sysm.as_dict(st), case.start_state(dict(pos=pos, vel=vel)))
    off = [set(torch.nonzero(start > TOL["start"]).flatten().tolist())]
    for _ in range(TICKS):
        noise = traffic.noise()
        inp = generator.clone(sysm.as_dict(st))
        st = sysm.tick(st, noise)
        gaps = check.tick_gaps(sysm.as_dict(st), case.tick(dict(inp=inp, noise=noise)))
        bad = torch.zeros(traffic.rows, dtype=torch.bool)
        for k, g in gaps.items():
            bad |= g > TOL[k]
        off.append(set(torch.nonzero(bad).flatten().tolist()))
    return off


@pytest.mark.parametrize("fault", [None, "du_row"])
def test_production_tick_follows_the_plain_reference(sweep, fault):
    """Every row of every tick within the tolerances; with ``du + 0.05``
    on row 0 where K1's answer is made (``system.rows_altered``), row 0,
    and only it, is off on every tick."""
    config, mix = sweep
    if fault is None:
        assert _rows_off(config, mix) == [set()] * (TICKS + 1)
        return
    with system.rows_altered(every=8, by=0.05):
        off = _rows_off(config, mix)
    assert off == [set()] + [{0}] * TICKS
