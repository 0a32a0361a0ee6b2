"""Multi-process runs of the PyTorch port (``parallel/distributed.py``):
real 2-process gloo groups on the CPU against one process, the counterpart
of ``tests/test_multihost.py``. Every group lives in subprocesses on a free
port, each with a timeout; the pytest process never joins one."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from doa_mpc_tpu_torch.config import SolverOptions, WorldSpec
from doa_mpc_tpu_torch.parallel import distributed
from doa_mpc_tpu_torch.sim.experiments import run_scenario_batch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 300
# 16 runs, 6 ticks, TF 0.5, N=5, M=3, 4 IP iterations (tests/test_multihost.py)
CLI_ARGS = ["experiment", "--device", "cpu", "--runs", "16", "--max-iter", "6", "--tf", "0.5",
            "--n-solv", "5", "--n-obst", "3", "--qp-iter", "4", "--scenarios", "RANDOM"]
# a rank of a group: the sharded rollout's statistics and gathered rows
WORKER = """
import json, sys, torch
from doa_mpc_tpu_torch.config import SolverOptions, WorldSpec, default_cost_params
from doa_mpc_tpu_torch.parallel import distributed
from doa_mpc_tpu_torch.parallel.mesh import make_data_mesh, make_sharded_rollout, tree_map
from doa_mpc_tpu_torch.sim.closed_loop import init_loop_state, metrics_of
from doa_mpc_tpu_torch.sim.obstacles import robot_start_goal
from doa_mpc_tpu_torch.solver.sqp_rti import make_rti_controller

rank, port = int(sys.argv[1]), sys.argv[2]
assert distributed.initialize(f"localhost:{port}", 2, rank)
spec = WorldSpec(tf=0.5, n_solv=5, n_obst=3, qp_iter=4)
ctrl = make_rti_controller(spec, SolverOptions(qp_iter=4, integrator="rk4"),
                           dtype=torch.float64, device="cpu")
start, goal = robot_start_goal(spec)
gen = torch.Generator().manual_seed(0)
state = init_loop_state(ctrl, start, goal, batch_shape=(16,), generator=gen)
lo, hi = distributed.host_shard_bounds(16)
mesh = make_data_mesh([torch.device("cpu")] * 2)
fn = make_sharded_rollout(ctrl, goal, default_cost_params(spec, dtype=torch.float64,
                                                          device="cpu"),
                          mesh, max_iter=6, generator=gen)
shards, stats = fn(distributed.make_global_batch(tree_map(lambda a: a[lo:hi], state), mesh))
rows = distributed.gather_rows(torch.cat([torch.stack([a.double() for a in metrics_of(s)], 1)
                                          for s in shards]))
print(json.dumps({"rank": rank, "bounds": [lo, hi], "mesh_size": mesh.size,
                  "host0": distributed.is_host0(), "stats": stats,
                  "rows": rows.tolist()}))
distributed.shutdown()
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env(**kw):
    env = dict(os.environ, PYTHONPATH=REPO, **kw)
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        if k not in kw:
            env.pop(k, None)
    return env


def _run_ranks(make_cmd, make_env=lambda r: _env()):
    """Start both ranks, wait for both (killing both on a timeout), and
    return their outputs; each must exit 0."""
    procs = [subprocess.Popen(make_cmd(r), cwd=REPO, env=make_env(r), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    return outs


def _csvs(out_dir):
    return sorted(f for f in os.listdir(out_dir) if f.endswith(".csv"))


def test_cli_two_processes_match_one(tmp_path):
    """``experiment --distributed --device cpu`` as 2 ranks (torchrun's
    variables) writes the one-process run's CSV; rank 0 alone writes and
    prints the summary."""
    one = tmp_path / "one"
    res = subprocess.run([sys.executable, "-m", "doa_mpc_tpu_torch", *CLI_ARGS,
                          "--out", str(one)], cwd=REPO, env=_env(), capture_output=True,
                         text=True, timeout=TIMEOUT_S)
    assert res.returncode == 0, res.stderr
    two = tmp_path / "two"
    port = str(_free_port())
    outs = _run_ranks(
        lambda r: [sys.executable, "-m", "doa_mpc_tpu_torch", *CLI_ARGS, "--distributed",
                   "--out", str(two)],
        lambda r: _env(MASTER_ADDR="localhost", MASTER_PORT=port, WORLD_SIZE="2",
                       RANK=str(r), LOCAL_RANK=str(r)))
    assert len(_csvs(one)) == 1 and len(_csvs(two)) == 1
    assert len(os.listdir(two)) == 2                      # one CSV/JSON pair
    a = np.loadtxt(one / _csvs(one)[0], delimiter=";")
    b = np.loadtxt(two / _csvs(two)[0], delimiter=";")
    assert a.shape == b.shape == (16, 6)
    np.testing.assert_array_equal(a, b)
    assert [sum("collision=" in ln for ln in o.splitlines()) for o in outs] == [1, 0]
    assert "2 shard(s)" in outs[0]


def test_sharded_rollout_stats_cross_ranks():
    """Two ranks (explicit ``initialize`` arguments) x 2 CPU shards each: both
    ranks gather the one-process run's rows, in rank order, and hold the
    same statistics, the rows' sums and minimum over both ranks."""
    port = str(_free_port())
    outs = _run_ranks(lambda r: [sys.executable, "-c", WORKER, str(r), port])
    recs = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    assert [r["bounds"] for r in recs] == [[0, 8], [8, 16]]
    assert [r["host0"] for r in recs] == [True, False]
    assert [r["mesh_size"] for r in recs] == [4, 4]
    ref = run_scenario_batch(WorldSpec(tf=0.5, n_solv=5, n_obst=3, qp_iter=4),
                             SolverOptions(qp_iter=4, integrator="rk4"), "RANDOM", n_runs=16,
                             max_iter=6, dtype=torch.float64, device="cpu")
    for r in recs:
        np.testing.assert_array_equal(np.array(r["rows"]), ref)
        assert r["stats"] == dict(n=16.0, reached=ref[:, 1].sum(), hit=ref[:, 0].sum(),
                                  oob=ref[:, 5].sum(), steps_sum=ref[:, 4].sum(),
                                  min_margin=ref[:, 2].min())


def test_initialize_without_configuration_is_a_noop(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.initialize() is False
    assert distributed.initialize() is False
    assert distributed.is_host0() and distributed.process_count() == 1
    assert distributed.host_shard_bounds(7) == (0, 7)


@pytest.mark.parametrize("env,args", [
    ({"WORLD_SIZE": "2"}, {}),
    ({"MASTER_ADDR": "localhost", "MASTER_PORT": "1234", "WORLD_SIZE": "2"}, {}),
    ({"MASTER_ADDR": "localhost", "WORLD_SIZE": "2", "RANK": "0"}, {}),
    ({}, {"coordinator_address": "localhost:1234", "process_id": 0}),
])
def test_initialize_partial_configuration_raises(monkeypatch, env, args):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match="partial"):
        distributed.initialize(**args)


def test_host_shard_bounds_blocks_in_rank_order(monkeypatch):
    monkeypatch.setattr(distributed, "process_count", lambda: 4)
    monkeypatch.setattr(distributed, "process_index", lambda: 2)
    assert distributed.host_shard_bounds(100) == (50, 75)
    assert not distributed.is_host0()
    with pytest.raises(ValueError, match="not divisible"):
        distributed.host_shard_bounds(10)


def test_gather_rows_without_a_group_moves_rows_to_the_cpu():
    rows = {"a": torch.arange(6).reshape(3, 2), "b": torch.tensor([True, False, True])}
    out = distributed.gather_rows(rows)
    assert torch.equal(out["a"], rows["a"]) and torch.equal(out["b"], rows["b"])
