from transferable3d_torch.parallel.mesh import (  # noqa: F401
    batch_sharding, data_parallel_mesh, data_points_mesh, replicate,
    shard_batch)
