"""The system under test, ``doa_mpc_tpu_torch``, seen from the benchmark.

The only module of the benchmark that imports the program. It builds the
controller and the tick a configuration names, hands it the inputs the
traffic generator made (worlds, noise), and turns its loop state into the
plain dict of tensors the reference and the check read
(:data:`mpcbench.reference.tick.STATE_KEYS`).

The tick is ``sim.closed_loop.make_batched_tick`` with one goal and the
configuration's ``backend``, on a batch that ``init_loop_state`` starts:
the campaign main path (``run_scenario_batch``, ``sim/parity.py``).
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

from doa_mpc_tpu_torch.config import CostParams, SolverOptions, WorldSpec
from doa_mpc_tpu_torch.ops import cuda_build, integrators, ip_fused
from doa_mpc_tpu_torch.sim import closed_loop
from doa_mpc_tpu_torch.sim.obstacles import ObstacleState
from doa_mpc_tpu_torch.solver.sqp_rti import make_rti_controller

DTYPES = {"float32": torch.float32, "float64": torch.float64}

# the kernels the batched tick launches on the card, by the program's module
KERNEL_MODULES = {"k1": ip_fused, "k3": integrators}


def kernels_of(config) -> list[str]:
    """The hand-written kernels this configuration's tick runs."""
    ks = ["k1"] if config["backend"] == "fused" else []
    if config["solver"]["integrator"] == "irk":
        ks.append("k3")
    return ks


def load_kernels(config) -> dict:
    """Build (first run in a checkout) or load the configuration's kernels
    from the program's build directory; returns the seconds and whether a
    build happened."""
    t0 = time.perf_counter()
    built = []
    for k in kernels_of(config):
        mod = KERNEL_MODULES[k]
        path = os.path.join(cuda_build.BUILD_DIR, "lib%s_%s.so" % (
            os.path.splitext(os.path.basename(mod.KERNEL_SOURCE))[0],
            cuda_build.source_hash(mod.KERNEL_SOURCE)))
        if not os.path.exists(path):
            built.append(k)
        mod._library()
    return {"library_s": time.perf_counter() - t0, "built": built}


class System:
    """One configuration of the program on one device."""

    def __init__(self, config, device, random_move=True):
        self.config = config
        self.device = torch.device(device)
        self.dtype = DTYPES[config["dtype"]]
        w, s = config["world"], config["solver"]
        self.spec = WorldSpec(**w)
        self.opts = SolverOptions(**s)
        self.ctrl = make_rti_controller(self.spec, self.opts, dtype=self.dtype,
                                        device=self.device)
        kw = dict(dtype=self.dtype, device=self.device)
        self.params = CostParams(**{k: torch.tensor(v, **kw) for k, v in config["cost"].items()})
        self.goal = torch.tensor(config["goal"], **kw)
        self.start = torch.tensor(config["start"], **kw)
        self._tick = closed_loop.make_batched_tick(self.ctrl, self.goal, self.params,
                                                   random_move=random_move,
                                                   backend=config["backend"])

    def init(self, pos, vel):
        """A fresh batch on the given worlds, as the program starts one."""
        return closed_loop.init_loop_state(self.ctrl, self.start, self.goal,
                                           batch_shape=(pos.shape[0],),
                                           obst=ObstacleState(pos, vel))

    def tick(self, st, noise):
        """One tick of every row."""
        return self._tick(st, noise=noise)

    @staticmethod
    def as_dict(st) -> dict:
        return dict(x0=st.x0, x_traj=st.rti.x_traj, u_traj=st.rti.u_traj,
                    pos=st.obst.pos, vel=st.obst.vel, done=st.done, reached=st.reached,
                    oob=st.oob, min_margin=st.min_margin, dist=st.dist, steps=st.steps,
                    resets=st.resets)


@contextlib.contextmanager
def rows_altered(every: int = 20, by: float = 0.05):
    """A planted fault, for the check's calibration and tests: the batched
    solve's answer altered where it is produced, ``du + by`` on every
    ``every``-th row (5% of the rows at the default)."""
    orig = closed_loop.solve_ocp_qp_fused

    def altered(*args, **kwargs):
        sol = orig(*args, **kwargs)
        du = sol.du.clone()
        du[::every] += by
        return sol._replace(du=du)

    closed_loop.solve_ocp_qp_fused = altered
    try:
        yield
    finally:
        closed_loop.solve_ocp_qp_fused = orig
