"""Post-processing: LR consistency, occlusion fill, weighted median.

Data-parallel replacements for the reference's post-process family:
  - leftRightConsistencyCheck (CPU, src/Stereo3DMST.cpp:632-710)
  - leftRightCheck (GPU, src/PatchMatchStereoGPU.cu:2115-2153)
  - handleOcclusionSharedMemory nearest-valid min fill (.cu:1128-1288)
  - weightedMedianFilter (.cu:2436-2600)

The reference's per-pixel while-loop searches ("scan left until a valid
pixel") become two directional cumulative scans (`lax.cummax` over valid
indices), and the insertion-sort weighted median becomes a bisection on the
monotone cumulative-weight function with an exact snap to the crossing tap —
no data-dependent control flow anywhere.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import WeightedMedianConfig

__all__ = [
    "lr_occlusion_mask",
    "nearest_valid_fill",
    "lr_check_fill_pair",
    "lr_consistency",
    "weighted_median",
]


def lr_check_fill_pair(disp_l, disp_r, max_disp: float, min_disp: float):
    """LR-check both views against each other and fill the occluded pixels
    (the cost-volume pipeline's lr_check step — one definition shared by
    models/costvolume.py and parallel/tiled2d.py so the tiled==monolithic
    parity cannot drift). Returns (left, right) filled maps."""
    occ_l = lr_occlusion_mask(disp_l, disp_r, -1, max_disp, min_disp)
    occ_r = lr_occlusion_mask(disp_r, disp_l, +1, max_disp, min_disp)
    left = nearest_valid_fill(jnp.where(occ_l, 0.0, disp_l), ~occ_l)
    right = nearest_valid_fill(jnp.where(occ_r, 0.0, disp_r), ~occ_r)
    return left, right


def lr_occlusion_mask(
    disp_ref: jax.Array,
    disp_other: jax.Array,
    sign: int,
    max_disp: float,
    min_disp: float = 0.0,
    max_diff: float = 1.0,
) -> jax.Array:
    """Occlusion mask for one view (True = inconsistent/occluded).

    sign=-1 for a left-view map (match at x - d), +1 for a right-view map
    (match at x + d). Follows the GPU leftRightCheck
    (src/PatchMatchStereoGPU.cu:2115-2153): invalid when d <= 0, d > max_disp,
    d < min_disp, the match column is out of bounds, or
    |d - other(x + sign*round(d))| > max_diff.
    """
    w = disp_ref.shape[1]
    xs = jnp.arange(w)[None, :]
    d_round = jnp.round(disp_ref).astype(jnp.int32)
    match_x = xs + sign * d_round
    in_bounds = (match_x >= 0) & (match_x < w)
    other = jnp.take_along_axis(
        disp_other, jnp.clip(match_x, 0, w - 1), axis=1
    )
    consistent = jnp.abs(disp_ref - other) <= max_diff
    valid = (
        (disp_ref > 0.0)
        & (disp_ref <= max_disp)
        & (disp_ref >= min_disp)
        & in_bounds
        & consistent
    )
    return ~valid


def nearest_valid_fill(disp: jax.Array, valid: jax.Array) -> jax.Array:
    """Fill invalid pixels from row neighbors, reference rule
    (src/Stereo3DMST.cpp:676-708): take the nearest valid value to the LEFT;
    then if the nearest valid value to the RIGHT is smaller (or no left value
    existed), take that instead. Pixels with no valid neighbor become 0.

    The reference's two while-loops per pixel become one forward and one
    backward `cummax` over valid column indices. (Its OMP version reads the
    mask racily as other threads clear it; this is the deterministic
    originally-valid interpretation.)
    """
    h, w = disp.shape
    xs = jnp.broadcast_to(jnp.arange(w)[None, :], (h, w))

    left_idx = jax.lax.cummax(jnp.where(valid, xs, -1), axis=1)
    # cummin with reverse=True is a right-to-left scan: nearest valid index
    # at-or-right of each column.
    right_idx = jax.lax.cummin(jnp.where(valid, xs, w), axis=1, reverse=True)

    has_l = left_idx >= 0
    has_r = right_idx < w
    fl = jnp.take_along_axis(disp, jnp.clip(left_idx, 0, w - 1), axis=1)
    fr = jnp.take_along_axis(disp, jnp.clip(right_idx, 0, w - 1), axis=1)

    fill = jnp.where(
        has_l & has_r,
        jnp.minimum(fl, fr),
        jnp.where(has_l, fl, jnp.where(has_r, fr, 0.0)),
    )
    return jnp.where(valid, disp, fill)


def lr_consistency(
    left_disp: jax.Array,
    right_disp: jax.Array,
    max_disp: float,
    max_diff: float = 1.0,
    fill: bool = True,
):
    """Left-view LR consistency check + optional fill
    (ref: leftRightConsistencyCheck, src/Stereo3DMST.cpp:632-710).

    A left pixel is valid iff d = round(left(x)) satisfies x - d >= 0,
    0 <= d < max_disp and |left(x) - right(x - d)| <= max_diff. Invalid
    pixels are zeroed, then (if fill) replaced by the nearest-valid row
    neighbor rule of `nearest_valid_fill`.

    Returns (disp, valid_mask).
    """
    w = left_disp.shape[1]
    xs = jnp.arange(w)[None, :]
    d_round = jnp.round(left_disp).astype(jnp.int32)
    match_x = xs - d_round
    in_range = (match_x >= 0) & (d_round >= 0) & (d_round < max_disp)
    right_at = jnp.take_along_axis(right_disp, jnp.clip(match_x, 0, w - 1), axis=1)
    valid = in_range & (jnp.abs(left_disp - right_at) <= max_diff)
    disp = jnp.where(valid, left_disp, 0.0)
    if fill:
        disp = nearest_valid_fill(disp, valid)
    return disp, valid


def weighted_median(
    disp: jax.Array,
    bgr: jax.Array,
    occluded: jax.Array,
    cfg: WeightedMedianConfig = WeightedMedianConfig(),
    normalized_intensity: bool = True,
) -> jax.Array:
    """Color-weighted median of occluded pixels
    (ref: weightedMedianFilter, src/PatchMatchStereoGPU.cu:2436-2600).

    Reference semantics: over a 21x21 window, weight each tap by
    exp(-sqrt(L1_bgr(center, tap)) * gamma) with gamma = 25.5 for [0,1]
    images (0.1 for [0,255], .cu:2474), out-of-bounds taps contribute
    weight 0; output = the smallest tap disparity whose cumulative weight
    reaches half the total.

    The insertion sort becomes a bisection on the monotone step function
    S(m) = sum_j w_j * [d_j <= m], followed by an exact snap to the smallest
    tap value inside the final bracket — identical output once the bracket
    isolates the crossing. `tap_stride` subsamples the window grid (the same
    economy the reference's own huber cost uses, .cu:3126-3128); stride 1
    reproduces the reference exactly.

    Only pixels with `occluded` True are replaced.
    """
    win_r = cfg.window_size // 2
    gamma = 25.5 if normalized_intensity else 0.1
    h, w = disp.shape
    taps = [
        (dy, dx)
        for dy in range(-win_r, win_r + 1, cfg.tap_stride)
        for dx in range(-win_r, win_r + 1, cfg.tap_stride)
    ]

    pad_d = jnp.pad(disp, ((win_r, win_r), (win_r, win_r)))
    pad_c = jnp.pad(bgr, ((win_r, win_r), (win_r, win_r), (0, 0)))
    in_y = jnp.arange(h)[:, None]
    in_x = jnp.arange(w)[None, :]

    offs = jnp.array(taps, jnp.int32)  # (T, 2)

    def tap_dw(carry_m, off):
        dy, dx = off[0], off[1]
        d_t = jax.lax.dynamic_slice(pad_d, (dy + win_r, dx + win_r), (h, w))
        c_t = jax.lax.dynamic_slice(pad_c, (dy + win_r, dx + win_r, 0), (h, w, 3))
        cdiff = jnp.sqrt(jnp.sum(jnp.abs(c_t - bgr), axis=-1))
        inb = (
            (in_y + dy >= 0) & (in_y + dy < h) & (in_x + dx >= 0) & (in_x + dx < w)
        )
        wgt = jnp.where(inb, jnp.exp(-cdiff * gamma), 0.0)
        return d_t, wgt

    # Pass 1: total weight + value range (scan over taps, O(1) live memory)
    def range_step(carry, off):
        wsum, dmin, dmax = carry
        d_t, wgt = tap_dw(None, off)
        live = wgt > 0.0
        dmin = jnp.minimum(dmin, jnp.where(live, d_t, jnp.inf))
        dmax = jnp.maximum(dmax, jnp.where(live, d_t, -jnp.inf))
        return (wsum + wgt, dmin, dmax), None

    init = (
        jnp.zeros((h, w)),
        jnp.full((h, w), jnp.inf),
        jnp.full((h, w), -jnp.inf),
    )
    (wsum, dmin, dmax), _ = jax.lax.scan(range_step, init, offs)
    half = 0.5 * wsum

    def below_weight(m):
        def step(acc, off):
            d_t, wgt = tap_dw(None, off)
            return acc + jnp.where(d_t <= m, wgt, 0.0), None

        out, _ = jax.lax.scan(step, jnp.zeros((h, w)), offs)
        return out

    # Bisection: invariant S(lo) < half <= S(hi)
    def bisect(_, bounds):
        lo, hi = bounds
        mid = 0.5 * (lo + hi)
        s = below_weight(mid)
        return jnp.where(s >= half, lo, mid), jnp.where(s >= half, mid, hi)

    lo, hi = jax.lax.fori_loop(
        0, cfg.bisect_iters, bisect, (dmin - 1.0, dmax)
    )

    # Exact snap: smallest tap value in (lo, hi]
    def snap_step(acc, off):
        d_t, wgt = tap_dw(None, off)
        cand = jnp.where((wgt > 0.0) & (d_t > lo) & (d_t <= hi), d_t, jnp.inf)
        return jnp.minimum(acc, cand), None

    med, _ = jax.lax.scan(snap_step, jnp.full((h, w), jnp.inf), offs)
    med = jnp.where(jnp.isfinite(med), med, disp)
    return jnp.where(occluded, med, disp)
