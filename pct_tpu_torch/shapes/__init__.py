from pct_tpu_torch.shapes.generators import (  # noqa: F401
    SHAPES,
    generate_shape,
    generate_sphere,
    generate_cylinder,
    generate_torus,
    generate_egg_carton,
)
from pct_tpu_torch.shapes.analytic import (  # noqa: F401
    analytic_curvatures,
    analytic_area,
    analytic_energies,
    density_for_target_points,
)
