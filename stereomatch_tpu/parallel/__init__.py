"""Multi-chip SPMD layer: mesh construction, halo exchange, tiled pipelines.

The reference is single-process single-GPU (SURVEY.md §2.4-2.5); its
parallelism axes (OpenMP rows, CUDA blocks, disparity-slice streams,
dual-stream L/R) map onto a `jax.sharding.Mesh` here:

  axis "frame" — data parallel over stereo pairs (the FLIR sequence,
                 streaming-video config)
  axis "tile"  — spatial tiles of the image (rows); windowed ops exchange
                 halos with `ppermute`
  axes "tile_y" x "tile_x" x "dslab" — the full SURVEY §5 mesh (tiled2d):
                 2-D image tiles plus the H x W x D volume sharded over
                 disparity slabs, WTA = one argmin-combine collective
"""

from .mesh import make_mesh, tile_rows_sharding  # noqa: F401
from .halo import halo_exchange_rows  # noqa: F401
from .tiled import tiled_cost_volume_batch, tiled_cost_volume_stereo  # noqa: F401
from .tiled2d import make_mesh3, tiled2d_cost_volume_stereo  # noqa: F401
from .dslab import wta_disparity_dslab  # noqa: F401
from .multihost import (  # noqa: F401
    distributed_init,
    make_host_mesh,
    tiled2d_cost_volume_batch,
)
from .sgbm_mesh import sgbm_batch_mesh  # noqa: F401
from .sgbm_pipeline import sgbm_pipeline_mesh  # noqa: F401
