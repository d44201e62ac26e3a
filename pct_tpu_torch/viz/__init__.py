"""Plots and viewers of the port: copies of the JAX package's ``viz``
on the port's ``shapes`` and ``io``.

They take numpy arrays; a caller that holds tensors passes
``t.cpu().numpy()``. They need matplotlib, which the card's machine
lacks: no device path of the port imports this package (the façade's
plot methods and the command line's ``view-figs``, ``view-meshes`` and
``plot-results`` import it inside the call).
"""

from pct_tpu_torch.viz.plots import (  # noqa: F401
    plot_points_colored_by_curvature,
    plot_pca_curvature,
    plot_surface,
    visualize_knn_for_random_points,
)
from pct_tpu_torch.viz.results import (  # noqa: F401
    load_results,
    plot_curvature_histograms,
    plot_disp_energies,
    plot_error_scatter,
)
from pct_tpu_torch.viz.view import view_figs, view_meshes  # noqa: F401
