from sonicscribe_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    make_mesh,
    replicate_params,
    shard_batch,
)
