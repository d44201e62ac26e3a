"""Outlier filters (parity with ref pointCloudToolbox.py:195-268).

The port's own numpy copy of ``pct_tpu.utils.filters``, unchanged.

The reference ships three filters, none wired into its drivers (call
sites commented out, ref :947-950):

- ``running_mean_outlier`` (ref :195-226): delta-based 2σ replacement —
  BUGGED in the reference: it returns inside the first loop iteration
  (ref :225-226). We implement the evidently-intended semantics (full
  pass) and document the divergence; ``compat_first_iteration=True``
  reproduces the reference's actual single-step behavior.
- ``filter_outliers_median`` (ref :228-250): MAD-based mask; flagged
  samples replaced by the previous kept value (the reference's
  window-1 neighbor mean degenerates to exactly that).
- ``filter_outliers_absolute`` (ref :252-268): |x| > max_abs → NaN.

All vectorized numpy; the JAX package's z-score sweep equivalent lives
in its ``validate.harness.zscore_filter``.
"""

from __future__ import annotations

import numpy as np


def running_mean_outlier(x: np.ndarray, window: int = 10,
                         n_sigma: float = 2.0,
                         compat_first_iteration: bool = False) -> np.ndarray:
    """Replace samples whose delta from the running mean exceeds
    n_sigma · running-std with the running mean."""
    x = np.asarray(x, dtype=np.float64).copy()
    out = x.copy()
    n = len(x)
    stop = min(n, window + 1) if compat_first_iteration else n
    for i in range(1, stop):
        lo = max(0, i - window)
        mu = out[lo:i].mean()
        sd = out[lo:i].std()
        if sd > 0 and abs(x[i] - mu) > n_sigma * sd:
            out[i] = mu
        if compat_first_iteration and i == 1:
            break   # ref :225-226 returns after the first iteration
    return out


def filter_outliers_median(data: np.ndarray, threshold: float = 100.0
                           ) -> np.ndarray:
    """MAD mask: |x − median| / MAD > threshold → replace with previous
    kept value (ref :228-250)."""
    data = np.asarray(data, dtype=np.float64).copy()
    med = np.median(data)
    mad = np.median(np.abs(data - med))
    if mad == 0:
        return data
    bad = np.abs(data - med) / mad > threshold
    out = data.copy()
    last_good = med
    for i in range(len(out)):
        if bad[i]:
            out[i] = last_good
        else:
            last_good = out[i]
    return out


def filter_outliers_absolute(data: np.ndarray, max_abs: float = 100.0
                             ) -> np.ndarray:
    """|x| > max_abs → NaN (ref :252-268)."""
    data = np.asarray(data, dtype=np.float64).copy()
    data[np.abs(data) > max_abs] = np.nan
    return data
