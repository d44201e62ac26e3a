from pct_tpu_torch.curvature.explicit import Curvatures, explicit_curvatures  # noqa: F401
