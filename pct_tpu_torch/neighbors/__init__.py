from pct_tpu_torch.neighbors.bruteforce import (  # noqa: F401
    knn_bruteforce,
    knn_cloud,
    mean_nn_distance,
)
from pct_tpu_torch.neighbors.grid import (  # noqa: F401
    GridIndex,
    build_grid,
    estimate_cell_size,
)
from pct_tpu_torch.neighbors.knn import (  # noqa: F401
    NeighborResult,
    ball_grid,
    knn_cloud_grid,
    knn_grid,
)
