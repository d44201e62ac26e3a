from pct_tpu_torch.shapes.analytic import analytic_curvatures  # noqa: F401
from pct_tpu_torch.shapes.generators import generate_shape  # noqa: F401
