"""Each cell end to end at a CPU size, the check against faults and the
control, and the arithmetic of the end-to-end metrics."""

import math
import os

import pytest
import torch

from common import BENCH, ROOT, WORKLOADS, run_tiny
from mpcbench import check, generator, harness


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_runs_end_to_end_and_is_correct(monkeypatch, workload):
    result, lines = run_tiny(monkeypatch, workload)
    assert result["correct"], result["check"]
    assert result["attempted"] > 0 and result["failed"] == 0
    want = {m["name"] for m in harness.metrics_for(BENCH, "end_to_end", workload)}
    assert set(result["metrics"]) == want and "setup_s" in want
    assert all(v["value"] > 0 for v in result["metrics"].values())
    assert list(result)[-1] == "check" and len(result["window"]["compared_ticks"]) == 3
    assert [ln.split()[1] for ln in lines] == list(check.NUMBERS)


def _unchanged(system, st, noise):
    return st


def _half(system, st, noise, tick):
    """Half of the batch left out: its rows keep their state."""
    new = tick(system, st, noise)
    out = torch.arange(st.x0.shape[0]) >= st.x0.shape[0] // 2

    def sel(o, u):
        return torch.where(out.reshape(out.shape + (1,) * (u.ndim - 1)), o, u)
    return type(new)(*(type(o)(*map(sel, o, u)) if isinstance(o, tuple) else sel(o, u)
                       for o, u in zip(st, new)))


FAULTS = ["unchanged", "half_batch", "answer_altered", "minority_rows_altered"]


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("workload", WORKLOADS)
def test_check_fails_a_broken_tick(monkeypatch, workload, fault):
    """A tick that returns its state unchanged, one that leaves half of the
    batch out, a solve whose answer is altered where it is produced on every
    row, and one altered on one row in eight (the 5% of the chip's readings
    is no row at this size): ``correct`` comes out false."""
    from doa_mpc_tpu_torch.sim import closed_loop
    from mpcbench import system as system_mod

    orig = system_mod.System.tick
    if fault == "unchanged":
        monkeypatch.setattr(system_mod.System, "tick", _unchanged)
    elif fault == "half_batch":
        monkeypatch.setattr(system_mod.System, "tick", lambda s, st, n: _half(s, st, n, orig))
    else:
        every = 1 if fault == "answer_altered" else 8
        with system_mod.rows_altered(every=every):
            assert closed_loop.solve_ocp_qp_fused.__name__ == "altered"
            result, _ = run_tiny(monkeypatch, workload)
        assert not result["correct"], result["check"]
        if every > 1:
            assert math.isclose(result["check"]["rows_off_pct"]["value"], 12.5), result["check"]
        return
    result, _ = run_tiny(monkeypatch, workload)
    assert not result["correct"], result["check"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_fails_the_limits(workload):
    """The reference in bfloat16 in the program's place fails the cell's
    limits (at a CPU size; the readings on the chip are in PERF.md)."""
    from common import tiny
    from mpcbench import system

    cell, config, mix, lim = tiny(*harness.cell_files(BENCH, workload))
    dev = torch.device("cpu")
    sysm = system.System(config, dev, random_move=mix["noise"])
    loop = generator.Loop(sysm, mix, generator.Traffic(mix, config, 7, dev),
                          capture=generator.check_ticks(mix, 7))
    loop.begin()
    generator.finish_captures(loop)
    numbers = check.compare(loop.captured, loop.starts, config, dev, lim["row_tol"])
    assert check.verdict(numbers, lim["limits"]), numbers
    captured, starts = check.control_outputs(loop.captured, loop.starts, config, dev)
    numbers = check.compare(captured, starts, config, dev, lim["row_tol"])
    assert not check.verdict(numbers, lim["limits"]), numbers


def test_rate_covers_every_tick_of_the_window():
    window = dict(solves=1000, window_s=4.0)
    assert harness.end_to_end("solves_per_s", window, 9.0) == 250.0
    assert harness.end_to_end("setup_s", window, 9.0) == 9.0
    with pytest.raises(ValueError):
        harness.end_to_end("solves_per_s_p50", window, 9.0)


def test_rows_off_counts_a_minority_of_rows():
    """The per-row count sees what the percentiles let through: 5% of the
    rows far off leave the 90th percentile and the median as they were."""
    n = 400
    g = {k: torch.full((n,), 1e-7, dtype=torch.float64)
         for k in ("start", "world", "state", "plan", "metric", "state_ref", "plan_ref")}
    tol = {"state": 1e-3, "plan": 1e-1}
    assert check.numbers(g, tol)["rows_off_pct"] == 0.0
    g["state"][::20] = 5e-3
    g["plan"][1::40] = 0.5
    got = check.numbers(g, tol)
    assert math.isclose(got["rows_off_pct"], 100.0 * (n // 20 + n // 40) / n)
    assert got["state_gap_p90"] == 1e-7 and got["plan_gap_p50"] == 1e-7
    # a row that the reference in the configuration's precision cannot
    # place either is not counted
    g["state_ref"][0] = 2e-3
    g["plan_ref"][1] = 0.2
    assert math.isclose(check.numbers(g, tol)["rows_off_pct"], 100.0 * (n // 20 + n // 40 - 2) / n)
    g["plan"][3] = math.nan
    assert check.numbers(g, tol)["plan_gap_p50"] == math.inf


def test_window_counts_every_row_of_every_tick(monkeypatch):
    result, _ = run_tiny(monkeypatch, "campaign_irk_qp100.pair200", seconds=1.0)
    w = result["window"]
    assert result["attempted"] == 8 * w["ticks"]
    assert math.isclose(result["metrics"]["solves_per_s"]["value"],
                        result["attempted"] / w["seconds"])


def test_cells_configs_mixes_and_metrics_are_found_by_name():
    bench = BENCH
    names = {c["name"] for c in bench["configs"]}
    for w in bench["workloads"]:
        cell, config, mix, lim = harness.cell_files(bench, w["name"])
        assert cell["config"] in names and set(lim["limits"]) == set(check.NUMBERS)
        assert set(lim["row_tol"]) == {"state", "plan"}
        assert set(lim["readings"]) == set(check.NUMBERS)
        reported = harness.metrics_for(bench, "per_layer", w["name"])
        assert reported, w["name"]
        moves = {m["moves"] for m in reported}
        e2e = {m["name"] for m in harness.metrics_for(bench, "end_to_end", w["name"])}
        assert moves <= e2e and "setup_s" in e2e and len(e2e) >= 2
    for c in bench["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))
    for m in bench["per_layer"] + bench["end_to_end"]:
        assert set(m.get("workloads", [])) <= {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert callable(harness.reader(m["name"]))


def test_seed_fixes_the_traffic():
    _, config, mix, _ = harness.cell_files(BENCH, "campaign_irk_qp100.pair200")
    a, b = (generator.Traffic(mix, config, 2**33 + 5, "cpu") for _ in range(2))
    for x, y in zip(a.worlds() + (a.noise(),), b.worlds() + (b.noise(),)):
        assert torch.equal(x, y)
    assert generator.check_ticks(mix, 2**33 + 5) == generator.check_ticks(mix, 2**33 + 5)
