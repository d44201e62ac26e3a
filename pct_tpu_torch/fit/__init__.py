from pct_tpu_torch.fit.eigh3 import eigh3, eigvalsh3, smallest_eigvec3  # noqa: F401
from pct_tpu_torch.fit.frames import (  # noqa: F401
    estimate_normals,
    neighborhood_covariance,
    rodrigues_to_z,
    tangent_frames,
)
from pct_tpu_torch.fit.quadratic import (  # noqa: F401
    cholesky_solve,
    fit_quadratic,
    fit_quadratic_lstsq_oracle,
    quadratic_design,
)
from pct_tpu_torch.fit.quadric import (  # noqa: F401
    fit_quadric,
    quadric_design,
    smallest_eigvec_10,
)
