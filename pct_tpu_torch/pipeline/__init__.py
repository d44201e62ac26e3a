from pct_tpu_torch.pipeline.fused import (  # noqa: F401
    FusedResult,
    fast_curvature,
    fused_curvature,
    plan_engine,
)
