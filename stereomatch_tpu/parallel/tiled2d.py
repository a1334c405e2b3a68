"""Full SURVEY §5 mesh: (tile_y, tile_x, dslab) SPMD cost-volume pipeline.

Completes the round-1 row-tiled pipeline (parallel/tiled.py) with the two
missing mesh axes:

  - **tile_x**: 2-D image tiling. Images stay row-sharded (they are tiny
    next to the volume: 2048x1536x3 f32 = 36 MB vs GB-scale volumes), so
    each device slices its own column block + halo locally — the corner
    halos come for free from the full-width rows, with no extra
    collectives beyond the row halo exchange over tile_y.
  - **dslab**: the (H, W, D) cost volume itself is sharded over D. Cost
    build and guided filtering are slice-local; WTA is one argmin-combine
    collective (parallel/dslab.py) — the mesh analog of the reference's
    disparity-slice parallelism (src/PatchMatchStereoGPU.cu:8584-8617,
    :8733-8769).

The Huber denoise runs on the 2-D (tile_y, tile_x) grid, exchanging one
boundary row AND one boundary column per primal-dual iteration (the
5-point stencil needs no corner exchange).

Property: tiled2d == monolithic models/costvolume.py to fp tolerance
(tests/test_parallel.py on the virtual 8-device CPU mesh).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from .tiled import shard_map, _guided_volume_block
from ..config import CostVolumePipelineConfig, DenoiseConfig
from ..ops.cost import bgr_to_gray
from .dslab import wta_disparity_dslab
from .halo import halo_exchange_rows

__all__ = ["tiled2d_cost_volume_stereo", "make_mesh3"]


def make_mesh3(n_ty: int, n_tx: int, n_dslab: int, devices=None) -> Mesh:
    """Build a (tile_y, tile_x, dslab) mesh (SURVEY §5's mesh minus the
    host/frame axis, which composes on the outside via tiled.py's frame
    batching)."""
    import numpy as np

    devices = list(devices if devices is not None else jax.devices())
    n = n_ty * n_tx * n_dslab
    assert n <= len(devices), (n_ty, n_tx, n_dslab, len(devices))
    arr = np.array(devices[:n]).reshape(n_ty, n_tx, n_dslab)
    return Mesh(arr, ("tile_y", "tile_x", "dslab"))


def _adgrad_block(left_e, right_e, v, gx0, wext, d0, ds, wfull):
    """AD+gradient cost volumes for one (rows+halo, cols+halo, d-shard)
    block (same math as ops.cost.adgrad_bgr_volumes, sliced).

    left_e/right_e: row-extended full-width BGR blocks; gx0: global column
    of the block's first column (traced; may be negative in the halo);
    d0: first global disparity index of this shard (traced); ds: shard
    depth (static).
    Out-of-global-image rows/cols get ZERO cost (the monolithic guided
    filter's zero padding); in-image pixels whose match column is out of
    range get bad_cost, exactly like the monolithic builder.
    """
    he = left_e.shape[0]
    nd_total = v.num_disp

    def grad_x(g):
        return jnp.diff(g, axis=1, append=g[:, -1:])

    gray_l = bgr_to_gray(left_e)
    gray_r = bgr_to_gray(right_e)
    gl, gr = grad_x(gray_l), grad_x(gray_r)

    # pad enough that every dynamic slice below is in range
    pad = v.min_disp + nd_total + wext
    wreg = wext + ds - 1

    def region(arr, start_col):
        p = [(0, 0)] * arr.ndim
        p[1] = (pad, pad)
        ap = jnp.pad(arr, p, mode="edge")
        sizes = (he, wreg) + arr.shape[2:]
        starts = (0, pad + start_col) + (0,) * (arr.ndim - 2)
        return lax.dynamic_slice(ap, starts, sizes)

    def build(ref_bgr, ref_grad, match_bgr, match_grad, sign):
        if sign < 0:  # left reference: match at x - (min_disp + d0 + k)
            start = gx0 - v.min_disp - d0 - (ds - 1)
            k_off = lambda k: ds - 1 - k  # noqa: E731
        else:  # right reference: match at x + (min_disp + d0 + k)
            start = gx0 + v.min_disp + d0
            k_off = lambda k: k  # noqa: E731
        mreg = region(match_bgr, start)
        greg = region(match_grad, start)
        slices_c, slices_g = [], []
        for k in range(ds):
            o = k_off(k)
            slices_c.append(lax.slice_in_dim(mreg, o, o + wext, axis=1))
            slices_g.append(lax.slice_in_dim(greg, o, o + wext, axis=1))
        match_stack = jnp.stack(slices_c, axis=2)  # (He, Wext, Ds, 3)
        grad_stack = jnp.stack(slices_g, axis=2)
        color_l1 = jnp.sum(jnp.abs(ref_bgr[:, :, None, :] - match_stack), axis=-1)
        grad_l1 = jnp.abs(ref_grad[:, :, None] - grad_stack)
        return v.color_weight * jnp.minimum(
            color_l1 * (1.0 / 3.0), v.color_truncation
        ) + v.gradient_weight * jnp.minimum(grad_l1, v.gradient_truncation)

    gxs = gx0 + jnp.arange(wext)  # global columns (traced)
    dvals = v.min_disp + d0 + jnp.arange(ds)  # global disparities (traced)

    rvol = build(region(right_e, gx0)[:, :wext], region(gr, gx0)[:, :wext],
                 left_e, gl, +1)
    rvol = jnp.where((gxs[:, None] + dvals[None, :] + 1 < wfull)[None],
                     rvol, v.bad_cost)
    lvol = build(region(left_e, gx0)[:, :wext], region(gl, gx0)[:, :wext],
                 right_e, gr, -1)
    lvol = jnp.where(
        ((gxs[:, None] - dvals[None, :] >= 0) & (gxs[:, None] + 1 < wfull))[None],
        lvol, v.bad_cost,
    )
    return lvol.astype(jnp.float32), rvol.astype(jnp.float32), gray_l, gray_r


def _huber_denoise_tiled2d(f, weight, cfg: DenoiseConfig, ay: str, ax: str):
    """Weighted-Huber primal-dual on a 2-D (tile_y, tile_x) grid, one
    boundary row + one boundary column exchanged per iteration. Matches
    ops.variational.huber_denoise exactly (see tiled._huber_denoise_tiled
    for the 1-D derivation; this adds the column direction)."""
    ny, nx = lax.axis_size(ay), lax.axis_size(ax)
    iy, ix = lax.axis_index(ay), lax.axis_index(ax)
    is_last_y = iy == ny - 1
    is_last_x = ix == nx - 1
    hs, ws = f.shape
    row = jnp.arange(hs)[:, None]
    col = jnp.arange(ws)[None, :]

    def body(_, state):
        u, q, px, py = state
        u_below = lax.ppermute(u[:1], ay, [(i + 1, i) for i in range(ny - 1)])
        dy = jnp.concatenate([u, u_below], axis=0)[1:] - u
        dy = jnp.where(is_last_y & (row == hs - 1), 0.0, dy)
        u_right = lax.ppermute(u[:, :1], ax, [(i + 1, i) for i in range(nx - 1)])
        dx = jnp.concatenate([u, u_right], axis=1)[:, 1:] - u
        dx = jnp.where(is_last_x & (col == ws - 1), 0.0, dx)

        q_new = (q + cfg.sigma * (u - f)) / (1.0 + cfg.sigma * cfg.gamma)
        q_new = q_new / jnp.maximum(1.0, jnp.abs(q_new) / cfg.lam)
        px_new = (px + cfg.sigma * dx) / (1.0 + cfg.sigma * cfg.delta)
        py_new = (py + cfg.sigma * dy) / (1.0 + cfg.sigma * cfg.delta)
        norm = jnp.maximum(1.0, jnp.sqrt(px_new**2 + py_new**2) / weight)
        px_new, py_new = px_new / norm, py_new / norm

        px_eff = jnp.where(is_last_x & (col == ws - 1), 0.0, px_new)
        py_eff = jnp.where(is_last_y & (row == hs - 1), 0.0, py_new)
        px_prev = lax.ppermute(
            px_eff[:, -1:], ax, [(i, i + 1) for i in range(nx - 1)]
        )
        px_ext = jnp.concatenate([px_prev, px_eff], axis=1)
        div_x = px_ext[:, 1:] - px_ext[:, :-1]
        py_prev = lax.ppermute(py_eff[-1:], ay, [(i, i + 1) for i in range(ny - 1)])
        py_ext = jnp.concatenate([py_prev, py_eff], axis=0)
        div_y = py_ext[1:] - py_ext[:-1]

        u_new = u + 2.0 * cfg.tau * (div_x + div_y - cfg.lam * q_new)
        return u_new, q_new, px_new, py_new

    zeros = jnp.zeros_like(f)
    u, _, _, _ = lax.fori_loop(0, cfg.iterations, body, (f, zeros, zeros, zeros))
    return u


def _body2d(left, right, cfg, denoise, halo, n_ty, n_tx, n_dd, wfull, h_total,
            lr_check=False):
    v, g = cfg.volume, cfg.guided
    hs = left.shape[0]
    ws = wfull // n_tx
    ds = v.num_disp // n_dd
    iy = lax.axis_index("tile_y")
    ix = lax.axis_index("tile_x")
    idd = lax.axis_index("dslab")
    gx0 = ix * ws - halo
    d0 = idd * ds
    wext = ws + 2 * halo

    left_e = halo_exchange_rows(left, halo, "tile_y")
    right_e = halo_exchange_rows(right, halo, "tile_y")

    grow = iy * hs + jnp.arange(-halo, hs + halo)
    lvol, rvol, gray_l_full, gray_r_full = _adgrad_block(
        left_e, right_e, v, gx0, wext, d0, ds, wfull
    )

    # out-of-global-image rows/cols -> zero cost + masked a/b (monolithic
    # zero padding); gray for guide stats likewise zero there
    gxs = gx0 + jnp.arange(wext)
    inb_row = (grow >= 0) & (grow < h_total)
    inb_col = (gxs >= 0) & (gxs < wfull)
    mask2d = inb_row[:, None] & inb_col[None, :]
    lvol = jnp.where(mask2d[..., None], lvol, 0.0)
    rvol = jnp.where(mask2d[..., None], rvol, 0.0)

    def gray_block(gray_full):
        gp = jnp.pad(gray_full, ((0, 0), (halo, halo)))
        blk = lax.dynamic_slice(gp, (0, halo + gx0), (gray_full.shape[0], wext))
        return jnp.where(mask2d, blk, 0.0)

    gl_blk = gray_block(gray_l_full)
    gr_blk = gray_block(gray_r_full)

    lvol = _guided_volume_block(gl_blk, lvol, g.radius, g.eps, g.slab, mask2d)
    rvol = _guided_volume_block(gr_blk, rvol, g.radius, g.eps, g.slab, mask2d)
    lvol = lvol[halo : halo + hs, halo : halo + ws]
    rvol = rvol[halo : halo + hs, halo : halo + ws]

    dl = wta_disparity_dslab(lvol, v.min_disp, "dslab")
    dr = wta_disparity_dslab(rvol, v.min_disp, "dslab")

    if denoise:
        span = float(v.max_disp - v.min_disp)
        row = jnp.arange(hs)[:, None]
        col = jnp.arange(ws)[None, :]
        is_last_y = iy == n_ty - 1
        is_last_x = ix == n_tx - 1

        def edge_weight_2d(gray_full):
            # forward diffs from the full-width row-extended gray: zero at
            # the GLOBAL last row/col (matches ops.variational.edge_weight)
            gsc = gray_full * (1.0 / 255.0)
            gp = jnp.pad(gsc, ((0, 0), (0, 1)), mode="edge")
            x0 = ix * ws
            blk = lax.dynamic_slice(gp, (halo, x0), (hs, ws))
            right_nb = lax.dynamic_slice(gp, (halo, x0 + 1), (hs, ws))
            below_nb = lax.dynamic_slice(gp, (halo + 1, x0), (hs, ws))
            dx = jnp.where(is_last_x & (col == ws - 1), 0.0, right_nb - blk)
            dy = jnp.where(is_last_y & (row == hs - 1), 0.0, below_nb - blk)
            mag = jnp.sqrt(dx * dx + dy * dy)
            return jnp.exp(-cfg.denoise.alpha * jnp.abs(mag) ** cfg.denoise.beta)

        wl = edge_weight_2d(gray_l_full)
        wr = edge_weight_2d(gray_r_full)
        fl = (dl - float(v.min_disp)) / span
        fr = (dr - float(v.min_disp)) / span
        dl = _huber_denoise_tiled2d(fl, wl, cfg.denoise, "tile_y", "tile_x")
        dl = dl * span + float(v.min_disp)
        dr = _huber_denoise_tiled2d(fr, wr, cfg.denoise, "tile_y", "tile_x")
        dr = dr * span + float(v.min_disp)

    if lr_check:
        # the LR check + directional fill scan the FULL row: all_gather the
        # (tiny) disparity rows along tile_x, run the SHARED row ops
        # (ops.postprocess.lr_check_fill_pair — same definition the
        # monolithic pipeline uses) redundantly, slice the block back out
        from ..ops.postprocess import lr_check_fill_pair

        dl_f = lax.all_gather(dl, "tile_x", axis=1, tiled=True)
        dr_f = lax.all_gather(dr, "tile_x", axis=1, tiled=True)
        dl_f, dr_f = lr_check_fill_pair(
            dl_f, dr_f, float(v.max_disp), float(v.min_disp)
        )
        x0 = ix * ws
        dl = lax.dynamic_slice(dl_f, (0, x0), (hs, ws))
        dr = lax.dynamic_slice(dr_f, (0, x0), (hs, ws))
    return dl, dr


def tiled2d_cost_volume_stereo(
    mesh: Mesh,
    shape: tuple[int, int],
    cfg: CostVolumePipelineConfig = CostVolumePipelineConfig(),
    denoise: bool = True,
    lr_check: bool = False,
):
    """Build a jitted cost-volume pipeline sharded over a
    (tile_y, tile_x, dslab) mesh.

    shape: global (H, W). H must divide by the tile_y axis, W by tile_x,
    and cfg.volume.num_disp by dslab. Images come in (H, W, 3) float32
    row-sharded (or unsharded — jit reshards); disparities come out
    (tile_y, tile_x)-sharded.
    """
    h_total, wfull = shape
    n_ty = mesh.shape["tile_y"]
    n_tx = mesh.shape["tile_x"]
    n_dd = mesh.shape["dslab"]
    assert h_total % n_ty == 0 and wfull % n_tx == 0
    assert cfg.volume.num_disp % n_dd == 0
    halo = 2 * cfg.guided.radius

    def body(left, right):
        return _body2d(
            left, right, cfg, denoise, halo, n_ty, n_tx, n_dd, wfull, h_total,
            lr_check,
        )

    in_spec = P("tile_y")
    out_spec = P("tile_y", "tile_x")
    fn = shard_map(
        body, mesh=mesh, in_specs=(in_spec, in_spec), out_specs=(out_spec, out_spec)
    )
    return jax.jit(fn)
