"""Multi-process orchestration (``doa_mpc_tpu/parallel/distributed.py``).

A campaign can split its scenario rows over several processes, each driving
its own device(s), joined by one ``torch.distributed`` process group:

- :func:`initialize` joins the group, from explicit arguments or the
  variables ``torchrun`` sets; without either it is a no-op, so every driver
  can call it unconditionally.
- :func:`host_shard_bounds` / :func:`make_global_batch`: each process keeps
  its contiguous block of the scenario rows and places it on its devices.
- :func:`gather_rows` all-gathers per-row metrics so that process 0
  (:func:`is_host0`) alone writes the CSV/JSON artifacts.

Why gloo and not NCCL. Only the Monte-Carlo statistics (6 scalars) and the
per-row metrics (B x 6 values) cross processes, once per run; they travel
as CPU tensors, where NCCL would gain nothing. NCCL also refuses two ranks
on one GPU, the only multi-rank layout a one-card machine can run. The
rollout itself stays on each process's card. The group is created with an
explicit timeout, so a lost peer fails the run instead of hanging it.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

# how long a collective (or the first rendezvous) waits for a peer
TIMEOUT = datetime.timedelta(minutes=10)


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               local_device_ids=None) -> bool:
    """Join the process group; returns True if this process is in one.

    Configuration precedence: explicit arguments, then the environment
    (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
    ``LOCAL_RANK``, as ``torchrun`` sets them). With neither, this is a
    single-process run and the call is a no-op that returns False; a second
    call is harmless. ``coordinator_address`` is ``host:port`` (or a
    ``tcp://`` URL) of process 0. ``local_device_ids`` are the CUDA
    ordinals of this process (default ``[LOCAL_RANK]``); when a card is
    present the first becomes the current CUDA device, which
    :func:`parallel.mesh.make_data_mesh` then uses. A partial
    configuration raises ``ValueError``."""
    env = os.environ
    if coordinator_address is None and env.get("MASTER_ADDR"):
        coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '')}"
    if num_processes is None and env.get("WORLD_SIZE"):
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and env.get("RANK"):
        process_id = int(env["RANK"])
    if local_device_ids is None and env.get("LOCAL_RANK"):
        local_device_ids = [int(env["LOCAL_RANK"])]
    given = (coordinator_address, num_processes, process_id)
    if all(v is None for v in given):
        return False
    if dist.is_initialized():
        return True
    if any(v is None for v in given) or coordinator_address.endswith(":"):
        raise ValueError(
            "a partial distributed configuration: need the coordinator address "
            "(host:port), the number of processes and this process's id; got "
            f"{coordinator_address!r}, {num_processes!r}, {process_id!r}")
    if local_device_ids and torch.cuda.is_available():
        torch.cuda.set_device(local_device_ids[0] % torch.cuda.device_count())
    url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group("gloo", init_method=url, world_size=num_processes,
                            rank=process_id, timeout=TIMEOUT)
    return True


def shutdown() -> None:
    """Leave the process group, after every process has reached this point
    (process 0 hosts the group's store); a no-op without a group."""
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_host0() -> bool:
    """True on the process responsible for artifact IO."""
    return process_index() == 0


def host_shard_bounds(global_n: int) -> tuple[int, int]:
    """[start, stop) of this process's contiguous scenario rows: process i
    holds the i-th of equal blocks, in rank order."""
    p, i = process_count(), process_index()
    if global_n % p:
        raise ValueError(f"global batch {global_n} not divisible by {p} processes")
    k = global_n // p
    return i * k, (i + 1) * k


def make_global_batch(local_tree, mesh):
    """Place this process's rows (every leaf's leading axis is the local
    scenario count) on its mesh devices, as contiguous blocks.

    There is no global array in torch: the batch exists as each process's
    blocks, and only :func:`gather_rows` (or the statistics of
    :func:`parallel.mesh.make_sharded_rollout`) crosses processes. Returns
    the list of per-device shards of :func:`parallel.mesh.shard_leading_axis`."""
    from doa_mpc_tpu_torch.parallel.mesh import shard_leading_axis

    return shard_leading_axis(local_tree, mesh)


def gather_rows(tree):
    """All-gather per-row tensors so that every process sees every row.

    Every leaf holds this process's rows (the same count on every process,
    as :func:`host_shard_bounds` makes them); the result's leaves are CPU
    tensors of all rows, process 0's first. Without a group the leaves are
    only moved to the CPU."""
    from doa_mpc_tpu_torch.parallel.mesh import tree_map

    def gather(x):
        x = x.detach().cpu().contiguous()
        if not dist.is_initialized():
            return x
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, x)
        return torch.cat(parts)

    return tree_map(gather, tree)
