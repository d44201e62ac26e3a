from pct_tpu_torch.curvature.explicit import Curvatures, explicit_curvatures  # noqa: F401
from pct_tpu_torch.curvature.implicit import implicit_curvatures  # noqa: F401
from pct_tpu_torch.curvature.pca import (  # noqa: F401
    PCACurvatures,
    pca_principal_curvatures,
    surface_variation,
)
