from doa_mpc_tpu_torch.parallel.mesh import (  # noqa: F401
    make_data_mesh,
    shard_leading_axis,
    make_sharded_rollout,
)
