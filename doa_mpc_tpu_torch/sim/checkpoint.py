"""Checkpoint / resume for long Monte-Carlo runs (``doa_mpc_tpu/sim/checkpoint.py``).

Any closed-loop state (:class:`~doa_mpc_tpu_torch.sim.closed_loop.LoopState`,
:class:`~doa_mpc_tpu_torch.solver.sqp_rti.RtiState`,
:class:`~doa_mpc_tpu_torch.sim.obstacles.ObstacleState`, a tensor, or a tuple
of them) can be snapshotted mid-rollout and resumed. The carried state is
the whole solver state, warm starts included, so resuming is exact.

Format: one ``.npz`` holding the leaves as ``leaf_0000``, ``leaf_0001``, ...
(NamedTuples flattened depth-first in field order) and a JSON ``header``
with ``magic``, ``n_leaves`` and ``meta``: the JAX package's layout. So an
``RtiState`` or ``ObstacleState`` saved by either package loads in the
other (same leaves in the same order and shapes). A whole ``LoopState``
does not cross: the JAX one carries a per-row PRNG ``key`` leaf that the
port's has not.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

_MAGIC = "doa_mpc_tpu/ckpt/v1"


def _leaf_key(i: int) -> str:
    return f"leaf_{i:04d}"


def _flatten(state):
    """Tensor leaves of ``state`` in depth-first field order."""
    if isinstance(state, torch.Tensor):
        return [state]
    if isinstance(state, tuple):
        return [leaf for part in state for leaf in _flatten(part)]
    raise TypeError(f"cannot checkpoint a {type(state).__name__}")


def _unflatten(like, leaves):
    """``like``'s structure with its tensors taken in order from the
    iterator ``leaves``."""
    if isinstance(like, torch.Tensor):
        return next(leaves)
    parts = [_unflatten(part, leaves) for part in like]
    return type(like)(*parts) if hasattr(like, "_fields") else type(like)(parts)


def save_state(path: str, state, meta: dict | None = None) -> None:
    """Snapshot ``state`` (leaves copied to the host) to ``path`` atomically."""
    leaves = _flatten(state)
    payload = {_leaf_key(i): t.detach().cpu().numpy() for i, t in enumerate(leaves)}
    header = {"magic": _MAGIC, "n_leaves": len(leaves), "meta": meta or {}}
    payload["header"] = np.frombuffer(json.dumps(header).encode(), dtype=np.uint8)
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    os.replace(tmp, path)


def load_state(path: str, like):
    """Restore a snapshot into the structure of ``like``.

    Returns (state, meta). Each leaf goes to the device and dtype of the
    matching leaf of ``like``; a leaf count or shape that differs raises, so
    a changed configuration cannot resume from an incompatible snapshot."""
    with np.load(path) as data:
        header = json.loads(bytes(data["header"]).decode())
        if header.get("magic") != _MAGIC:
            raise ValueError(f"{path} is not a doa_mpc_tpu checkpoint")
        refs = _flatten(like)
        if header["n_leaves"] != len(refs):
            raise ValueError(f"checkpoint has {header['n_leaves']} leaves, expected "
                             f"{len(refs)}: config mismatch?")
        leaves = []
        for i, ref in enumerate(refs):
            arr = data[_leaf_key(i)]
            if tuple(arr.shape) != tuple(ref.shape):
                raise ValueError(f"leaf {i}: checkpoint shape {arr.shape} != "
                                 f"expected {tuple(ref.shape)}")
            leaves.append(torch.as_tensor(arr, dtype=ref.dtype, device=ref.device))
    return _unflatten(like, iter(leaves)), header.get("meta", {})


def rollout_with_checkpoints(rollout_chunk, state, n_chunks: int, path: str,
                             meta: dict | None = None, resume: bool = True):
    """Run ``rollout_chunk`` (state -> state) ``n_chunks`` times, saving a
    snapshot after each chunk; resumes from ``path`` if it exists and
    ``resume`` is set (e.g. 400 ticks as 8 chunks of 50)."""
    start_chunk = 0
    if resume and os.path.exists(path):
        state, saved = load_state(path, state)
        start_chunk = int(saved.get("chunk", 0))
    for chunk in range(start_chunk, n_chunks):
        state = rollout_chunk(state)
        save_state(path, state, {**(meta or {}), "chunk": chunk + 1})
    return state
