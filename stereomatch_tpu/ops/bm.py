"""Block matching (StereoBM) with the full OpenCV parameter surface.

The reference's legacy CLI configures cv::StereoBM with
preFilterCap=31, blockSize 9, textureThreshold=10, uniquenessRatio=15,
speckle 100/32 and disp12MaxDiff=1 (src/stereo_opencv (copy).cpp:258-268);
the StereoMatching class wraps the same engine (BMStereo,
src/StereoMatching.cpp:116-146). This module re-derives that algorithm
as one fused pass over an (H, W, D) SAD volume:

  - prefilter: clipped horizontal Sobel (shared with SGBM's
    xsobel_clipped — OpenCV's PREFILTER_XSOBEL with the same kernel);
  - cost: window SAD of the prefiltered pair via cumsum box sums
    (OpenCV's sliding-window row buffers collapse into two cumsums);
  - texture: window sum of |prefiltered - cap| < textureThreshold
    invalidates (findStereoCorrespondenceBM's htext accumulator);
  - WTA with OpenCV's reversed-index tie-breaking (ties go to the LARGER
    disparity), uniqueness thresh = minSAD + floor(minSAD*ratio/100),
    OpenCV-BM subpixel (p - n) / (p + n - 2*minSAD + |p - n|);
  - disp12 cross-check by min-cost projection, floor/ceil tolerant like
    cv::validateDisparity;
  - border/ROI invalidation matching cv::getValidDisparityROI.

Speckle filtering is ops/speckle.py (shared with SGBM), applied by the
pipeline wrapper. Output is float32 disparity; invalid = min_disp - 1.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import BMConfig
from .sgbm import xsobel_clipped

__all__ = ["bm_disparity", "BMOutput"]

# np scalar, NOT jnp: a module-level jax array would initialize the
# backend at import time; np.float32 has identical dtype semantics
_BIG = np.float32(1e9)


class BMOutput(NamedTuple):
    disparity: jax.Array  # float32, invalid = min_disp - 1
    valid: jax.Array  # bool


def _window_sum(x: jax.Array, radius: int) -> jax.Array:
    """Separable (2r+1)^2 window sum, edge-replicated (interior exact;
    borders are invalidated by the ROI mask anyway)."""
    from .filters import box_filter_sum

    if radius == 0:
        return x
    pad = ((radius, radius), (radius, radius)) + ((0, 0),) * (x.ndim - 2)
    s = jnp.pad(x, pad, mode="edge")
    s = box_filter_sum(box_filter_sum(s, radius, 0), radius, 1)
    return s[radius:-radius, radius:-radius]


def valid_disparity_roi(
    roi1: tuple[int, int, int, int],
    roi2: tuple[int, int, int, int],
    min_disp: int,
    num_disp: int,
    block_size: int,
) -> tuple[int, int, int, int]:
    """cv::getValidDisparityROI: intersect the two rectification
    valid-pixel ROIs (from stereo_rectify) with the disparity search
    band and the block border — the rectangle the legacy CLI's BM
    restricts itself to (ref: bm->setROI1/2 feeding from stereoRectify,
    src/stereo_opencv (copy).cpp:258-268). Returns (x, y, w, h), all
    zeros when empty. cv2-oracle-tested."""
    sw2 = block_size // 2
    min_d, max_d = min_disp, min_disp + num_disp - 1
    xmin = max(roi1[0], roi2[0] + max_d) + sw2
    xmax = min(roi1[0] + roi1[2], roi2[0] + roi2[2] + min_d) - sw2
    ymin = max(roi1[1], roi2[1]) + sw2
    ymax = min(roi1[1] + roi1[3], roi2[1] + roi2[3]) - sw2
    if xmax - xmin > 0 and ymax - ymin > 0:
        return (xmin, ymin, xmax - xmin, ymax - ymin)
    return (0, 0, 0, 0)


def bm_disparity(
    left_gray: jax.Array,
    right_gray: jax.Array,
    cfg: BMConfig = BMConfig(),
) -> BMOutput:
    """StereoBM left-view disparity (no speckle pass — see pipelines)."""
    h, w = left_gray.shape
    nd = cfg.num_disp
    r = cfg.block_size // 2
    cap = float(cfg.prefilter_cap)

    pl = xsobel_clipped(left_gray.astype(jnp.float32), cfg.prefilter_cap)
    pr = xsobel_clipped(right_gray.astype(jnp.float32), cfg.prefilter_cap)

    from .cost import shifted_stack

    rstack, in_bounds = shifted_stack(pr, nd, -1, cfg.min_disp)
    sad = _window_sum(jnp.abs(pl[:, :, None] - rstack), r)

    # texture: window sum of |prefiltered left - cap|
    tsum = _window_sum(jnp.abs(pl - cap), r)

    # WTA with OpenCV's tie-breaking: StereoBM scans disparities in
    # REVERSED index order, so ties go to the larger disparity.
    best = nd - 1 - jnp.argmin(jnp.flip(sad, axis=-1), axis=-1)
    min_s = jnp.min(sad, axis=-1)
    ds = jnp.arange(nd)[None, None, :]
    b3 = best[..., None]
    pre = jnp.min(jnp.where(ds == b3 - 1, sad, _BIG), axis=-1)
    nxt = jnp.min(jnp.where(ds == b3 + 1, sad, _BIG), axis=-1)
    # sad[-1] := sad[1], sad[nd] := sad[nd-2] (OpenCV's mirror) makes the
    # subpixel offset exactly 0 at the ends
    pre = jnp.where(best == 0, nxt, pre)
    nxt = jnp.where(best == nd - 1, pre, nxt)

    # uniqueness: integer thresh = minSAD + floor(minSAD*ratio/100); any
    # d with |d - best| > 1 and SAD <= thresh invalidates
    if cfg.uniqueness_ratio > 0:
        thresh = min_s + jnp.floor(min_s * (cfg.uniqueness_ratio / 100.0))
        bad = (sad <= thresh[..., None]) & (jnp.abs(ds - b3) > 1)
        unique_ok = ~jnp.any(bad, axis=-1)
    else:
        unique_ok = jnp.ones((h, w), bool)

    texture_ok = tsum >= float(cfg.texture_threshold)

    # OpenCV BM subpixel: offset = (p - n) / (p + n - 2*minSAD + |p - n|)
    # where p = SAD(d-1), n = SAD(d+1) in disparity units (the reference's
    # reversed index ordering unreversed)
    p, n = pre, nxt
    denom = p + n - 2.0 * min_s + jnp.abs(p - n)
    offset = jnp.where(denom > 0, (p - n) / denom, 0.0)
    disp = best + cfg.min_disp + offset

    # valid ROI (cv::getValidDisparityROI): the left margin where some d
    # would read out of the right image, plus the block-radius border
    xs = jnp.arange(w)[None, :]
    ys = jnp.arange(h)[:, None]
    roi_ok = (
        (xs >= cfg.min_disp + nd - 1 + r)
        & (xs < w - r)
        & (ys >= r)
        & (ys < h - r)
    )
    if cfg.roi1 is not None and cfg.roi2 is not None:
        # rectification ROIs: restrict to getValidDisparityROI like
        # cv::StereoBM with setROI1/setROI2
        rx, ry, rw, rh = valid_disparity_roi(
            cfg.roi1, cfg.roi2, cfg.min_disp, nd, cfg.block_size
        )
        roi_ok = roi_ok & (xs >= rx) & (xs < rx + rw) & (ys >= ry) & (ys < ry + rh)

    # disp12 cross-check (cv::validateDisparity semantics): right disparity
    # by min-cost projection of surviving left pixels, then floor/ceil-
    # tolerant comparison
    if cfg.disp12_max_diff >= 0:
        bestd = best + cfg.min_disp
        xr = xs - bestd
        proj_ok = unique_ok & texture_ok & roi_ok & (xr >= 0)
        ysb = jnp.broadcast_to(ys, (h, w))
        xrc = jnp.clip(xr, 0, w - 1)
        cost_scatter = jnp.full((h, w), _BIG).at[ysb, xrc].min(
            jnp.where(proj_ok, min_s, _BIG)
        )
        hit_cost = cost_scatter[ysb, xrc]
        is_winner = proj_ok & (min_s <= hit_cost)
        disp2 = jnp.full((h, w), -(2**20)).at[ysb, xrc].max(
            jnp.where(is_winner, bestd, -(2**20))
        )

        def _fails(dd):
            xr1 = xs - dd
            d2_at = disp2[ysb, jnp.clip(xr1, 0, w - 1)]
            has = (d2_at > -(2**20)) & (xr1 >= 0) & (xr1 < w)
            return has & (jnp.abs(d2_at - dd) > cfg.disp12_max_diff)

        lr_ok = ~(
            _fails(jnp.floor(disp).astype(jnp.int32))
            & _fails(jnp.ceil(disp).astype(jnp.int32))
        )
    else:
        lr_ok = jnp.ones((h, w), bool)

    valid = unique_ok & texture_ok & roi_ok & lr_ok
    out = jnp.where(valid, disp, float(cfg.min_disp - 1)).astype(jnp.float32)
    return BMOutput(out, valid)
