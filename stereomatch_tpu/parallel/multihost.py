"""Multi-host composition: frames across hosts, tiles/slabs within one.

SURVEY §5's distributed design ends at mesh
`(host, tile_y, tile_x, dslab)`: stereo pairs (the streaming FLIR
sequence) distributed across hosts over the network, and each frame's
pixels / disparity slabs sharded across the host's devices. The reference
has no distributed story at all (§2.5: single process, single GPU); this
module supplies the composition layer on top of parallel/tiled2d.py:

  - `distributed_init` — standard single-controller bootstrap
    (jax.distributed.initialize) with env autodetection; a no-op when
    the process is alone, so the same program runs on a laptop, one
    host, or a pod slice.
  - `make_host_mesh` — the 4-axis mesh. The host axis varies SLOWEST, so
    on a real pod its groups coincide with process boundaries: every
    collective inside a frame (halo ppermutes, dslab argmin-combine,
    denoise boundary exchange) stays on ICI; nothing crosses DCN but the
    initial frame scatter and final disparity gather, which jit's
    sharding layer performs automatically.
  - `tiled2d_cost_volume_batch` — the (tile_y, tile_x, dslab) pipeline
    vmapped over a host-sharded frame batch.

All of it is testable host-side on the virtual CPU mesh (SURVEY §4);
tests/test_parallel.py checks batch == per-frame monolithic on a
(2 host, 2, 2, 1) mesh of 8 CPU devices.
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh, PartitionSpec as P

from ..config import CostVolumePipelineConfig
from .tiled import shard_map
from .tiled2d import _body2d

__all__ = ["distributed_init", "make_host_mesh", "tiled2d_cost_volume_batch"]


def distributed_init(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> bool:
    """Initialize jax.distributed when running multi-process; returns True
    if a multi-process runtime was initialized. Arguments fall back to the
    standard env (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES /
    JAX_PROCESS_ID, or the cluster autodetection built into
    jax.distributed). Safe to call when single-process (returns False)."""
    import os

    addr = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    nproc = num_processes if num_processes is not None else os.environ.get(
        "JAX_NUM_PROCESSES"
    )
    if addr is None and nproc is None:
        return False  # single process: nothing to do
    jax.distributed.initialize(
        coordinator_address=addr,
        num_processes=int(nproc) if nproc is not None else None,
        process_id=int(process_id)
        if process_id is not None
        else int(os.environ.get("JAX_PROCESS_ID", 0)),
    )
    return True


def make_host_mesh(
    n_host: int, n_ty: int, n_tx: int, n_dslab: int, devices=None
) -> Mesh:
    """(host, tile_y, tile_x, dslab) mesh with host varying slowest — on a
    pod slice the host groups line up with processes (jax.devices() is
    process-major), keeping per-frame collectives on ICI."""
    import numpy as np

    devices = list(devices if devices is not None else jax.devices())
    n = n_host * n_ty * n_tx * n_dslab
    assert n <= len(devices), (n_host, n_ty, n_tx, n_dslab, len(devices))
    arr = np.array(devices[:n]).reshape(n_host, n_ty, n_tx, n_dslab)
    return Mesh(arr, ("host", "tile_y", "tile_x", "dslab"))


def tiled2d_cost_volume_batch(
    mesh: Mesh,
    shape: tuple[int, int],
    cfg: CostVolumePipelineConfig = CostVolumePipelineConfig(),
    denoise: bool = True,
    lr_check: bool = False,
):
    """Batched (B, H, W, 3) pipeline: frames sharded over "host" (DCN),
    each frame tiled over (tile_y, tile_x, dslab) (ICI). B must divide by
    the host axis; H/W/D constraints as in tiled2d_cost_volume_stereo.
    lr_check applies the same full-row LR consistency + directional fill
    the single-frame pipeline offers (tiled2d._body2d's all_gather'ed row
    path) per frame — the frame vmap carries the collective along."""
    h_total, wfull = shape
    n_ty = mesh.shape["tile_y"]
    n_tx = mesh.shape["tile_x"]
    n_dd = mesh.shape["dslab"]
    assert h_total % n_ty == 0 and wfull % n_tx == 0
    assert cfg.volume.num_disp % n_dd == 0
    halo = 2 * cfg.guided.radius

    def body(lb, rb):  # (B_local, Hs, W, 3)
        return jax.vmap(
            lambda l, r: _body2d(
                l, r, cfg, denoise, halo, n_ty, n_tx, n_dd, wfull, h_total,
                lr_check,
            )
        )(lb, rb)

    in_spec = P("host", "tile_y")
    out_spec = P("host", "tile_y", "tile_x")
    fn = shard_map(
        body, mesh=mesh, in_specs=(in_spec, in_spec), out_specs=(out_spec, out_spec)
    )
    return jax.jit(fn)
