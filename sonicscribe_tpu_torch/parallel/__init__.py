from sonicscribe_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    batch_sharding,
    make_mesh,
    replicate_params,
    replicated,
    shard_batch,
    shard_params_tp,
)
