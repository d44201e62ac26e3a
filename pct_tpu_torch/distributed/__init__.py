"""The distributed layer on ``torch.distributed``: port of
``pct_tpu.distributed`` (query-sharded fused curvature, the slab path
with its halo exchange, the sample-sort grid build). Every rank runs the
same call (SPMD); NCCL on the card, gloo on the CPU."""

from pct_tpu_torch.distributed.sharding import (  # noqa: F401
    POINTS_AXIS,
    ShardedResult,
    make_mesh,
    sharded_curvature,
)
from pct_tpu_torch.distributed.slab import (  # noqa: F401
    SlabResult,
    slab_curvature,
    slab_curvature_unsorted,
)
from pct_tpu_torch.distributed.sort import (  # noqa: F401
    DistGrid,
    build_grid_distributed,
)
