"""Carry state across from the JAX package.

The functions take the JAX package's pytrees with numpy leaves (any object
with the same attribute names, or with ``_asdict()``) and return the port's
types on ``device`` in ``dtype``. Integer and boolean leaves keep their
integer/boolean type. Nothing here imports JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from doa_mpc_tpu_torch.config import CostParams, resolve_device
from doa_mpc_tpu_torch.ops.ocp_qp import OcpQp
from doa_mpc_tpu_torch.rl.env import EnvState
from doa_mpc_tpu_torch.sim.closed_loop import LoopState
from doa_mpc_tpu_torch.sim.obstacles import ObstacleState
from doa_mpc_tpu_torch.solver.sqp_rti import RtiState


def _get(obj, name):
    if hasattr(obj, "_asdict"):
        return obj._asdict()[name]
    return getattr(obj, name)


def _tensor(a, device, dtype):
    a = np.array(a)          # a writable copy, whatever the leaf type
    if a.dtype == np.bool_ or np.issubdtype(a.dtype, np.integer):
        return torch.as_tensor(a, device=device)
    return torch.as_tensor(a, dtype=dtype, device=device)


def _convert(cls, obj, device, dtype):
    dev = resolve_device(device)
    return cls(**{f: _tensor(_get(obj, f), dev, dtype) for f in cls._fields})


def cost_params_from_numpy(p, device="cuda", dtype=torch.float32) -> CostParams:
    dev = resolve_device(device)
    return CostParams(**{f.name: _tensor(_get(p, f.name), dev, dtype)
                         for f in dataclasses.fields(CostParams)})


def obstacle_state_from_numpy(o, device="cuda", dtype=torch.float32) -> ObstacleState:
    return _convert(ObstacleState, o, device, dtype)


def rti_state_from_numpy(r, device="cuda", dtype=torch.float32) -> RtiState:
    return _convert(RtiState, r, device, dtype)


def ocp_qp_from_numpy(qp, device="cuda", dtype=torch.float32) -> OcpQp:
    return _convert(OcpQp, qp, device, dtype)


def loop_state_from_numpy(s, device="cuda", dtype=torch.float32) -> LoopState:
    """The JAX ``LoopState`` without its PRNG ``key`` (the port has none)."""
    dev = resolve_device(device)
    fields = {f: _tensor(_get(s, f), dev, dtype)
              for f in LoopState._fields if f not in ("rti", "obst")}
    return LoopState(rti=rti_state_from_numpy(_get(s, "rti"), dev, dtype),
                     obst=obstacle_state_from_numpy(_get(s, "obst"), dev, dtype),
                     **fields)


def env_state_from_numpy(s, device="cuda", dtype=torch.float32) -> EnvState:
    """The JAX ``rl.env.EnvState``; its loop through
    :func:`loop_state_from_numpy`."""
    dev = resolve_device(device)
    return EnvState(loop=loop_state_from_numpy(_get(s, "loop"), dev, dtype),
                    **{f: _tensor(_get(s, f), dev, dtype) for f in EnvState._fields[1:]})


def ddpg_params_from_numpy(flax_params, module: torch.nn.Module) -> torch.nn.Module:
    """Load a flax ``{'params': {'_MLP_0': {'Dense_i': {'kernel', 'bias'}}}}``
    tree (numpy or array leaves) into the port's ``Actor`` or ``Critic``, in
    place, and return the module. A flax kernel is (in, out), an
    ``nn.Linear`` weight (out, in), so each kernel is transposed."""
    dense = flax_params["params"]["_MLP_0"]
    layers = module.mlp.layers
    if len(dense) != len(layers):
        raise ValueError(f"{len(dense)} Dense layers for {len(layers)} nn.Linear layers")
    with torch.no_grad():
        for i, layer in enumerate(layers):
            d = dense[f"Dense_{i}"]
            layer.weight.copy_(torch.as_tensor(np.array(d["kernel"]).T))
            layer.bias.copy_(torch.as_tensor(np.array(d["bias"])))
    return module
