"""Scenario data parallelism over devices (``doa_mpc_tpu/parallel/mesh.py``).

All parallelism is over the scenario batch (per-problem parallelism is
pointless at nx=5). A :class:`DataMesh` holds this process's devices and
the process group, if there is one; its shards are the JAX mesh's
``"data"`` axis: world size x local devices, each holding a contiguous
block of rows.

- :func:`shard_leading_axis` splits a batch into one block per local device;
- :func:`make_sharded_rollout` runs the batched tick on every shard, the
  shards in lockstep tick by tick (so several cards overlap), and reduces
  the Monte-Carlo statistics over shards and processes.

The JAX package carries a PRNG key per row, so its rows draw the same
obstacle noise however they are split. Here one ``torch.Generator`` draws
the noise of the whole batch in the batch's shape, so a shard cannot draw
its own: each tick draws the global (B, M, 2) block from the generator and
hands every shard its rows. A sharded run then gives the unsharded run's
rows on the same device type, however the rows are split.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from doa_mpc_tpu_torch.config import CostParams, resolve_device
from doa_mpc_tpu_torch.parallel.distributed import host_shard_bounds, process_count
from doa_mpc_tpu_torch.sim.closed_loop import make_batched_tick, metrics_of
from doa_mpc_tpu_torch.solver.sqp_rti import RtiController, make_rti_controller


def tree_map(fn, *trees):
    """``fn`` over the tensor leaves of NamedTuples and dicts of tensors."""
    t = trees[0]
    if isinstance(t, torch.Tensor):
        return fn(*trees)
    if isinstance(t, dict):
        return {k: tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, tuple) and hasattr(t, "_fields"):
        return type(t)(*(tree_map(fn, *xs) for xs in zip(*trees)))
    raise TypeError(f"not a tree of tensors: {type(t).__name__}")


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """This process's devices, one row block each, and the process group
    (None in a single-process run)."""

    devices: tuple
    group: object = None

    @property
    def size(self) -> int:
        """The run's shard count: processes x local devices."""
        return process_count() * len(self.devices)


def make_data_mesh(devices=None) -> DataMesh:
    """A mesh over ``devices``; by default every local CUDA device, or on a
    rank of a process group ``cuda:LOCAL_RANK % device_count`` (the current
    CUDA device when ``LOCAL_RANK`` is unset). The tests pass
    ``[torch.device("cpu")] * 8``."""
    in_group = dist.is_initialized()
    if devices is None:
        resolve_device("cuda")
        count = torch.cuda.device_count()
        if in_group:
            local = int(os.environ.get("LOCAL_RANK", torch.cuda.current_device()))
            devices = [torch.device("cuda", local % count)]
        else:
            devices = [torch.device("cuda", i) for i in range(count)]
    devices = tuple(resolve_device(d) for d in devices)
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return DataMesh(devices=devices, group=dist.group.WORLD if in_group else None)


def shard_leading_axis(tree, mesh: DataMesh) -> list:
    """Split every leaf of ``tree`` (a ``LoopState``, say) into contiguous
    row blocks, one per local device of ``mesh``, each on its device."""
    k = len(mesh.devices)

    def block(a, i):
        if a.shape[0] % k:
            raise ValueError(f"{a.shape[0]} rows not divisible by {k} local devices")
        size = a.shape[0] // k
        return a[i * size:(i + 1) * size].to(mesh.devices[i])

    return [tree_map(lambda a, i=i: block(a, i), tree) for i in range(k)]


def make_sharded_rollout(ctrl: RtiController, goal, params: CostParams, mesh: DataMesh,
                         max_iter: int = 400, random_move: bool = True,
                         backend: str = "fused",
                         generator: torch.Generator | None = None):
    """The batched rollout (``sim.closed_loop.make_batched_rollout``) over the
    shards of ``mesh``.

    The JAX counterpart wraps a whole rollout; here the shards must advance
    tick by tick together, because one generator draws every row's noise,
    so this takes the rollout's arguments. Each local device runs
    ``make_batched_tick(backend=backend)`` on its shard with a controller
    of ``ctrl``'s configuration on that device. With ``random_move`` each
    tick draws the global (B, M, 2) noise block from ``generator`` (the
    default generator of the first shard's device when None), and each
    shard takes its rows of it.

    Returns ``fn(shards) -> (final_shards, stats)``: ``shards`` is this
    process's list from :func:`shard_leading_axis`; ``stats`` holds ``n``,
    ``reached``, ``hit``, ``oob`` and ``steps_sum`` summed over every shard
    of every process and ``min_margin`` as their minimum (Python floats,
    from float64)."""
    ctrls = {}
    for d in mesh.devices:
        if d not in ctrls:
            ctrls[d] = ctrl if d == ctrl.device else make_rti_controller(
                ctrl.spec, ctrl.options, dtype=ctrl.dtype, device=d)
    ticks = [make_batched_tick(ctrls[d], goal, params.to(device=d), random_move=random_move,
                               backend=backend) for d in mesh.devices]

    def fn(shards):
        if len(shards) != len(ticks):
            raise ValueError(f"{len(shards)} shards for {len(ticks)} local devices")
        sizes = [s.x0.shape[0] for s in shards]
        local_n = sum(sizes)
        lo, _ = host_shard_bounds(local_n * process_count())
        vel = shards[0].obst.vel
        home = vel.device if generator is None else generator.device
        for _ in range(max_iter):
            noise = [None] * len(shards)
            if random_move:
                draw = torch.randn((local_n * process_count(),) + vel.shape[1:],
                                   generator=generator, dtype=vel.dtype, device=home)
                noise = draw[lo:lo + local_n].split(sizes)
            shards = [tick(s, noise=None if z is None else z.to(s.x0.device))
                      for tick, s, z in zip(ticks, shards, noise)]
        return shards, _reduce_stats(shards)

    return fn


def _reduce_stats(shards) -> dict:
    """The Monte-Carlo aggregates of ``shards`` over every process."""
    sums = torch.zeros(5, dtype=torch.float64)
    low = torch.full((1,), float("inf"), dtype=torch.float64)
    for s in shards:
        m = metrics_of(s)
        sums += torch.stack([
            torch.tensor(float(m.reached.shape[0]), dtype=torch.float64, device=m.steps.device),
            *(a.to(torch.float64).sum() for a in (m.reached, m.hit, m.oob, m.steps))]).cpu()
        low = torch.minimum(low, m.min_margin.to(torch.float64).min().cpu())
    if dist.is_initialized():
        dist.all_reduce(sums, op=dist.ReduceOp.SUM)
        dist.all_reduce(low, op=dist.ReduceOp.MIN)
    n, reached, hit, oob, steps = sums.tolist()
    return {"n": n, "reached": reached, "hit": hit, "oob": oob, "steps_sum": steps,
            "min_margin": low.item()}
