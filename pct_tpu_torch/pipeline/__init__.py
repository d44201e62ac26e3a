from pct_tpu_torch.pipeline.curvature_pipeline import (  # noqa: F401
    PipelineResult,
    compute_pointwise_explicit_quadratic_curvature,
    compute_pointwise_implicit_quadric_curvature,
    curvature_pipeline,
    pointwise_curvature,
)
from pct_tpu_torch.pipeline.fused import (  # noqa: F401
    FusedResult,
    fast_curvature,
    fused_curvature,
    plan_engine,
)
from pct_tpu_torch.pipeline.mesh_pipeline import (  # noqa: F401
    MeshResult,
    create_mesh_with_curvature,
)
from pct_tpu_torch.pipeline.neighbor_study import (  # noqa: F401
    explicit_quadratic_neighbor_study,
)
