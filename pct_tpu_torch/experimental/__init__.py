"""The gather-free band kNN, port of ``pct_tpu.experimental``.

``band_select`` (``knn_band_select``, the kernel ``csrc/band_select.cu``)
+ ``band_knn`` (``knn_cellwise_band``, ``build_row_blocks``). The JAX
package keeps them as experimental because Mosaic cannot compile the
kernel's 1D DMAs at unaligned offsets on a TPU. A Hopper block has no
such alignment rule: it stages its nine bands into shared memory at any
row offset, so the path runs on the card. The band window is still
bounded: ``band`` may not exceed ``band_select.MAX_BAND`` (1024 rows,
the JAX DMA window), which keeps the staging within a block's shared
memory.
"""

from pct_tpu_torch.experimental.band_knn import (  # noqa: F401
    build_row_blocks,
    knn_cellwise_band,
)
from pct_tpu_torch.experimental.band_select import (  # noqa: F401
    MAX_BAND,
    band_select_plain,
    knn_band_select,
)
