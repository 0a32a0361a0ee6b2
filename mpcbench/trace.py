"""The traced run's segment: ``torch.profiler`` over a few ticks of the same
closed loop after the measured window, reduced to device-op intervals by
name, the device's busy time (the union of the intervals), and the longest
idle gaps with what the host was doing in each.

The per-layer readers (``metrics/<name>.py``) read a :class:`Trace`. The
kernels are matched by the names the profiler prints for them:
``ip_solve_kernel`` (K1), ``irk_step_kernel`` (K3; ``<float, 4, true>`` is
the linearization's step with the sensitivities, ``<float, 4, false>`` the
plant's).
"""

from __future__ import annotations

import time

import torch

from mpcbench import yardstick
from mpcbench.reference import ip as ref_ip, tick as ref_tick

KERNELS = {"k1": "ip_solve_kernel", "k3": "irk_step_kernel"}


class Trace:
    """What a traced segment of ``ticks`` ticks saw.

    ``ops``: device operations as (name, start_us, dur_us), sorted by start;
    ``host``: host-side operations the same way; ``window_s``: the
    segment's host seconds (it ends on a synchronize); ``config``, ``rows``
    and ``qp_input``: the configuration, the batch, and one profiled tick's
    input loop state, from which the operation counts are made."""

    def __init__(self, ops, host, ticks, window_s, config, rows, qp_input):
        self.ops, self.host, self.ticks, self.window_s = ops, host, ticks, window_s
        self.config, self.rows, self.qp_input = config, rows, qp_input
        self._counter = None
        self._k1_ops = None

    def busy_s(self) -> float:
        """Seconds in which some device operation ran: the union of the
        intervals."""
        total, end = 0.0, -float("inf")
        for _, s, d in self.ops:
            e = s + d
            if e > end:
                total += e - max(s, end)
                end = e
        return total / 1e6

    def gaps(self):
        """Idle intervals between device operations, (start_us, end_us)."""
        out, end = [], None
        for _, s, d in self.ops:
            if end is not None and s > end:
                out.append((end, s))
            end = s + d if end is None else max(end, s + d)
        return out

    def kernel(self, key):
        """(name, start_us, dur_us) of the launches of kernel ``key``."""
        return [o for o in self.ops if KERNELS[key] in o[0]]

    def counter(self) -> yardstick.OpCounter:
        if self._counter is None:
            self._counter = yardstick.OpCounter()
        return self._counter

    def k1_ops_per_tick(self, sample_rows: int = 128, seed: int = 0) -> float:
        """K1's operations in one tick: counted on a seeded sample of the
        profiled tick's rows (the reference builds their QPs from the loop
        state the tick received, in float64) and scaled by the batch."""
        if self._k1_ops is None:
            st, goal = self.qp_input, torch.tensor(self.config["goal"], dtype=torch.float64)
            g = torch.Generator().manual_seed(seed)
            idx = torch.randperm(self.rows, generator=g)[:sample_rows]
            sub = {k: v.double().cpu()[idx] for k, v in st.items()}
            cfg = self.config
            pred = ref_tick.forecast(sub["pos"], sub["vel"], cfg["world"],
                                     cfg["world"]["n_solv"], cfg["solver"]["compat_pred_bug"])
            params = {k: torch.tensor(v, dtype=torch.float64) for k, v in cfg["cost"].items()}
            qp = ref_ip.normalize(ref_tick.build_qp(sub, goal, pred, params,
                                                    cfg["world"], cfg["solver"]))
            n = self.counter().k1({k: getattr(qp, k).numpy() for k in qp._fields},
                                  cfg["solver"]["qp_iter"])
            self._k1_ops = n * self.rows / len(idx)
        return self._k1_ops

    def idle_pct(self):
        """The share of the segment in which no device operation ran."""
        return 100.0 * (1.0 - self.busy_s() / self.window_s) if self.ops else None

    def kernels_per_tick(self):
        """Device kernels launched per tick (copies and fills left out)."""
        n = sum(1 for o in self.ops if not o[0].startswith(("Memcpy", "Memset")))
        return n / self.ticks if n else None

    def ms_per_tick(self, key):
        """Device milliseconds of kernel ``key`` per tick."""
        ks = self.kernel(key)
        return sum(o[2] for o in ks) / 1e3 / self.ticks if ks else None

    def roofline_pct(self, key):
        """Kernel ``key``'s bound over its device time, in percent: per launch
        the larger of its bytes (from shapes) over the memory rate and its
        counted operations over the f32 rate."""
        ks = self.kernel(key)
        if not ks:
            return None
        w, s = self.config["world"], self.config["solver"]
        N, M, B = w["n_solv"], w["n_obst"], self.rows
        if key == "k1":
            bound = len(ks) * yardstick.bound_s(yardstick.k1_bytes(B, N, M), self.k1_ops_per_tick())
        else:
            bound = 0.0
            for name, _, _ in ks:
                sens = "true" in name.split(">")[0]
                rows = B * N if sens else B
                bound += yardstick.bound_s(
                    yardstick.k3_bytes(rows, s["irk_stages"], sens),
                    self.counter().k3(rows, s["irk_stages"], s["irk_newton_iter"], sens))
        return 100.0 * bound / (sum(o[2] for o in ks) / 1e6)

    def breakdown(self) -> dict:
        """The device operations with the most time, and the longest idle
        gaps named by the innermost host operation that covered each gap's
        middle (at most 10 each, seconds)."""
        by = {}
        for name, _, d in self.ops:
            by[name] = by.get(name, 0.0) + d / 1e6
        top = sorted(by.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:10]
        idle = []
        for a, b in gaps:
            mid, best = 0.5 * (a + b), None
            for name, s, d in self.host:
                if s > mid:
                    break
                if s + d >= mid and (best is None or d < best[1]):
                    best = (name, d)
            idle.append([best[0] if best else "(no host op)", (b - a) / 1e6])
        return {"device_ops": [[n[:120], s] for n, s in top], "idle_gaps": idle}


def profile_segment(loop, ticks: int, config, sync=torch.cuda.synchronize) -> Trace:
    """Profile ``ticks`` more ticks of ``loop`` after one warm-up cycle of the
    profiler as long, whose first tick's input is kept for the counts."""
    from torch.profiler import ProfilerActivity, profile, schedule

    first = loop.n
    loop.capture.add(first)
    cycles, spans = [], []
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=acts,
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: cycles.append(p.events())) as prof:
        for _ in range(2):
            sync()
            t0 = time.perf_counter()
            for _ in range(ticks):
                loop.step()
            sync()
            spans.append(time.perf_counter() - t0)
            prof.step()
    cap = next(c for c in loop.captured if c["n"] == first)
    loop.captured.remove(cap)
    loop.capture.discard(first)
    dev = torch.autograd.DeviceType.CUDA
    ops, host = [], []
    for e in cycles[-1]:
        if e.name.startswith("ProfilerStep"):
            continue
        rec = (e.name, e.time_range.start, e.time_range.end - e.time_range.start)
        (ops if e.device_type == dev else host).append(rec)
    ops.sort(key=lambda o: o[1])
    host.sort(key=lambda o: o[1])
    return Trace(ops, host, ticks, spans[-1], config, loop.rows, cap["inp"])
