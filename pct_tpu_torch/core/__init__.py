from pct_tpu_torch.core.cloud import (  # noqa: F401
    PointCloud,
    ReferenceState,
    from_numpy,
    from_reference_arrays,
    pad_capacity,
    to_numpy,
)
from pct_tpu_torch.core.device import resolve_device  # noqa: F401
