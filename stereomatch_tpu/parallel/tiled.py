"""Row-tiled SPMD cost-volume pipeline over a device mesh.

The monolithic pipeline (models/costvolume.py) sharded by image rows over
the mesh's "tile" axis with `shard_map`:

  - the AD+gradient cost is purely horizontal — each tile computes its own
    rows plus a recomputed halo band (cheaper than exchanging cost-volume
    halos: the halo is exchanged at the IMAGE level, 2*radius rows of
    pixels between devices, and the band's cost is recomputed locally);
  - the guided filter consumes the halo band and crops it off — interior
    results are bit-identical to the monolithic filter, and global edges
    reproduce its zero-padding via an explicit row mask;
  - WTA is per-pixel;
  - the Huber denoise exchanges ONE boundary row per primal-dual iteration
    (u downward, dual py upward), the image analog of ring/context
    parallelism (SURVEY.md §5).

`tiled_cost_volume_batch` adds the "frame" mesh axis: data-parallel stereo
pairs (the streaming FLIR-sequence config) with rows tile-sharded inside
each frame group.

Property: tiled == monolithic to fp tolerance (tested on the virtual
8-device CPU mesh, tests/test_parallel.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

try:  # jax >= 0.8
    from jax import shard_map
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

from ..config import CostVolumePipelineConfig, DenoiseConfig
from ..ops.cost import adgrad_bgr_volumes, bgr_to_gray
from ..ops.filters import box_filter
from ..ops.select import wta_disparity
from .halo import halo_exchange_rows

__all__ = ["tiled_cost_volume_stereo", "tiled_cost_volume_batch"]


def _guided_volume_block(gray, vol, radius, eps, slab, row_mask=None):
    """Guided filter on an extended block (same math as
    ops.filters.guided_filter_volume, zero-pad mode).

    row_mask marks rows (1-D) or pixels (2-D, for tiled2d's column halos)
    inside the GLOBAL image: a/b must be zeroed beyond the global edge
    before their own box filter, because the monolithic filter zero-pads
    there (halo pixels past the edge otherwise contribute nonzero a/b
    built from partial window statistics)."""
    mean_g = box_filter(gray, radius, (0, 1), "zero")
    var_g = box_filter(gray * gray, radius, (0, 1), "zero") - mean_g * mean_g
    denom = var_g + eps
    h, w, d = vol.shape
    pad_d = (-d) % slab
    if pad_d:
        vol = jnp.pad(vol, ((0, 0), (0, 0), (0, pad_d)))
    nslab = vol.shape[2] // slab
    vol_s = jnp.moveaxis(vol.reshape(h, w, nslab, slab), 2, 0)
    if row_mask is None:
        mask = None
    elif row_mask.ndim == 1:
        mask = row_mask.astype(vol.dtype)[:, None, None]
    else:
        mask = row_mask.astype(vol.dtype)[:, :, None]

    def step(_, p):
        mean_p = box_filter(p, radius, (0, 1), "zero")
        corr = box_filter(gray[..., None] * p, radius, (0, 1), "zero")
        a = (corr - mean_g[..., None] * mean_p) / denom[..., None]
        b = mean_p - a * mean_g[..., None]
        if mask is not None:
            a = a * mask
            b = b * mask
        q = box_filter(a, radius, (0, 1), "zero") * gray[..., None] + box_filter(
            b, radius, (0, 1), "zero"
        )
        return None, q

    _, out = lax.scan(step, None, vol_s)
    out = jnp.moveaxis(out, 0, 2).reshape(h, w, nslab * slab)
    return out[:, :, :d] if pad_d else out


def _huber_denoise_tiled(f, weight, cfg: DenoiseConfig, axis_name: str):
    """Weighted-Huber primal-dual on a row tile, exchanging one boundary
    row per iteration. Matches ops.variational.huber_denoise exactly:
    forward-diff gradients (zero at the global last row/col) and the
    reference's divergence boundary rule via zeroed last-row/col duals."""
    n = lax.axis_size(axis_name)
    idx = lax.axis_index(axis_name)
    is_last = idx == n - 1
    hs, w = f.shape

    col = jnp.arange(w)[None, :]
    row = jnp.arange(hs)[:, None]

    def body(_, state):
        u, q, px, py = state
        # u halo from next tile (one row) for dy at our last row
        u_next = lax.ppermute(u[:1], axis_name, [(i + 1, i) for i in range(n - 1)])
        u_ext = jnp.concatenate([u, u_next], axis=0)
        dy = u_ext[1:] - u_ext[:-1]
        dy = jnp.where(is_last & (row == hs - 1), 0.0, dy)
        dx = jnp.pad(u[:, 1:] - u[:, :-1], ((0, 0), (0, 1)))

        q_new = (q + cfg.sigma * (u - f)) / (1.0 + cfg.sigma * cfg.gamma)
        q_new = q_new / jnp.maximum(1.0, jnp.abs(q_new) / cfg.lam)
        px_new = (px + cfg.sigma * dx) / (1.0 + cfg.sigma * cfg.delta)
        py_new = (py + cfg.sigma * dy) / (1.0 + cfg.sigma * cfg.delta)
        norm = jnp.maximum(1.0, jnp.sqrt(px_new**2 + py_new**2) / weight)
        px_new, py_new = px_new / norm, py_new / norm

        # divergence: px with last col zeroed; py with global-last row zeroed
        px_eff = jnp.where(col == w - 1, 0.0, px_new)
        py_eff = jnp.where(is_last & (row == hs - 1), 0.0, py_new)
        div_x = px_eff - jnp.pad(px_eff[:, :-1], ((0, 0), (1, 0)))
        py_prev = lax.ppermute(
            py_eff[-1:], axis_name, [(i, i + 1) for i in range(n - 1)]
        )
        py_ext = jnp.concatenate([py_prev, py_eff], axis=0)
        div_y = py_ext[1:] - py_ext[:-1]

        u_new = u + 2.0 * cfg.tau * (div_x + div_y - cfg.lam * q_new)
        return u_new, q_new, px_new, py_new

    zeros = jnp.zeros_like(f)
    u, _, _, _ = lax.fori_loop(0, cfg.iterations, body, (f, zeros, zeros, zeros))
    return u


def _single_frame_body(left, right, cfg, denoise, halo, n_tiles):
    """Per-tile pipeline body (runs inside shard_map over the "tile" axis)."""
    v = cfg.volume
    g = cfg.guided
    hs = left.shape[0]
    idx = lax.axis_index("tile")

    # image-level halo exchange, then recompute cost on the band
    left_e = halo_exchange_rows(left, halo, "tile")
    right_e = halo_exchange_rows(right, halo, "tile")
    gray_l = bgr_to_gray(left_e)
    gray_r = bgr_to_gray(right_e)
    lvol, rvol = adgrad_bgr_volumes(left_e, right_e, v)

    # global-edge halo rows must be zero COST (monolithic zero-padding),
    # not the cost of zero-valued pixels
    grow = idx * hs + jnp.arange(-halo, hs + halo)[:, None, None]
    h_total = n_tiles * hs
    inb = (grow >= 0) & (grow < h_total)
    lvol = jnp.where(inb, lvol, 0.0)
    rvol = jnp.where(inb, rvol, 0.0)
    row_mask = inb[:, 0, 0]

    lvol = _guided_volume_block(gray_l, lvol, g.radius, g.eps, g.slab, row_mask)
    rvol = _guided_volume_block(gray_r, rvol, g.radius, g.eps, g.slab, row_mask)
    lvol = lvol[halo : halo + hs]
    rvol = rvol[halo : halo + hs]

    dl = wta_disparity(lvol, v.min_disp)
    dr = wta_disparity(rvol, v.min_disp)

    if denoise:
        span = float(v.max_disp - v.min_disp)
        row = jnp.arange(hs)[:, None]
        is_last = idx == n_tiles - 1

        def edge_weight_tiled(gray_e):
            # matches ops.variational.edge_weight: forward diffs, zero at
            # the GLOBAL last row/col; tile boundaries use the true halo
            # row, identical to monolithic.
            gsc = gray_e * (1.0 / 255.0)
            blk = gsc[halo : halo + hs]
            dx = jnp.pad(blk[:, 1:] - blk[:, :-1], ((0, 0), (0, 1)))
            dy = gsc[halo + 1 : halo + hs + 1] - blk
            dy = jnp.where(is_last & (row == hs - 1), 0.0, dy)
            mag = jnp.sqrt(dx * dx + dy * dy)
            return jnp.exp(-cfg.denoise.alpha * jnp.abs(mag) ** cfg.denoise.beta)

        wl = edge_weight_tiled(gray_l)
        wr_ = edge_weight_tiled(gray_r)
        fl = (dl - float(v.min_disp)) / span
        fr = (dr - float(v.min_disp)) / span
        dl = _huber_denoise_tiled(fl, wl, cfg.denoise, "tile") * span + float(v.min_disp)
        dr = _huber_denoise_tiled(fr, wr_, cfg.denoise, "tile") * span + float(v.min_disp)
    return dl, dr


def tiled_cost_volume_stereo(
    mesh: Mesh,
    cfg: CostVolumePipelineConfig = CostVolumePipelineConfig(),
    denoise: bool = True,
):
    """Build a jitted, mesh-sharded version of the cost-volume pipeline.

    Returns fn(left_bgr, right_bgr) -> (left_disp, right_disp) where the
    images are (H, W, 3) float32 with H divisible by the tile axis size.
    Outputs are row-sharded over the mesh.
    """
    halo = 2 * cfg.guided.radius
    n_tiles = mesh.shape["tile"]

    def body(left, right):
        return _single_frame_body(left, right, cfg, denoise, halo, n_tiles)

    spec = P("tile")
    fn = shard_map(body, mesh=mesh, in_specs=(spec, spec), out_specs=(spec, spec))
    return jax.jit(fn)


def tiled_cost_volume_batch(
    mesh: Mesh,
    cfg: CostVolumePipelineConfig = CostVolumePipelineConfig(),
    denoise: bool = True,
):
    """Batched variant: (B, H, W, 3) pairs sharded (frame, tile) — frames
    data-parallel over the mesh's "frame" axis (the streaming-video config:
    the FLIR sequence distributed over hosts, SURVEY.md §5), rows sharded
    over "tile" within each frame group."""
    halo = 2 * cfg.guided.radius
    n_tiles = mesh.shape["tile"]

    def body(lb, rb):
        return jax.vmap(
            lambda l, r: _single_frame_body(l, r, cfg, denoise, halo, n_tiles)
        )(lb, rb)

    spec = P("frame", "tile")
    fn = shard_map(body, mesh=mesh, in_specs=(spec, spec), out_specs=(spec, spec))
    return jax.jit(fn)
