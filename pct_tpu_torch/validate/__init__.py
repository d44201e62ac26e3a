"""Shape validation: the harness (``validate_cloud``), the analytic sweep
(``run_sweep``) and the batch run over scan files (``run_scans``). Port of
``pct_tpu.validate``."""

from pct_tpu_torch.validate.harness import (  # noqa: F401
    ValidationResult,
    percent_error,
    point_area_weights,
    validate_cloud,
    validate_file,
    zscore_filter,
)
from pct_tpu_torch.validate.sweep import run_sweep  # noqa: F401
from pct_tpu_torch.validate.scans import run_scans  # noqa: F401
