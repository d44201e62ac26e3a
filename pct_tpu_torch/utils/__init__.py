"""Host-side numpy helpers: outlier filters and geometry transforms."""
