from pct_tpu_torch.neighbors.bruteforce import (  # noqa: F401
    knn_bruteforce,
    mean_nn_distance,
)
from pct_tpu_torch.neighbors.grid import (  # noqa: F401
    GridIndex,
    build_grid,
    estimate_cell_size,
)
