"""Cost-volume stereo with guided-filter aggregation + variational denoise.

Data-parallel re-design of the reference's production GPU pipeline
`costVolumeStereoPlusVariationalDenoise` (src/PatchMatchStereoGPU.cu:8776-9410),
call stack SURVEY.md §3.4:

  1. pixelwise truncated AD + gray-gradient BGR cost volumes, both views
     (buildCostVolumeSharedMemoryBGR, .cu:8983-8984)
  2. gray-guided guided-filter smoothing of each volume with
     eps=(0.01*255)^2, radius 9 (.cu:9000-9001, pthread fan-out :9118-9153 —
     here a lax.scan over disparity slabs; left/right independence is
     expressed by batching, XLA overlaps them)
  3. WTA + parabola subpixel (selectDisparity, .cu:9212-9213)
  4. weighted-Huber primal-dual denoise, lambda=0.5 (.cu:9226-9227)

The reference's occlusion handling at this point is compiled out
(#if 0, .cu:9232-9239); `lr_check=True` enables the equivalent live path.
All stages are pure functions of the input pair; the whole pipeline jits
into one XLA program.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import (
    CostVolumeConfig,
    CostVolumePipelineConfig,
    GuidedFilterConfig,
)
from ..ops.cost import adgrad_bgr_volumes, bgr_to_gray
from ..ops.filters import guided_filter_volume
from ..ops.postprocess import lr_check_fill_pair
from ..ops.select import wta_disparity
from ..ops.variational import variational_disparity_denoise

__all__ = ["builtin_cost_volumes", "cost_volume_stereo", "CostVolumeOutput"]


class CostVolumeOutput(NamedTuple):
    left_disp: jax.Array
    right_disp: jax.Array
    left_raw: jax.Array  # WTA before denoise
    right_raw: jax.Array


def cost_volume_stereo(
    left_bgr: jax.Array,
    right_bgr: jax.Array,
    cfg: CostVolumePipelineConfig = CostVolumePipelineConfig(),
    denoise: bool = True,
    lr_check: bool = False,
) -> CostVolumeOutput:
    """Run the full cost-volume pipeline on a rectified BGR pair in [0, 255].

    Returns float32 disparities for both views (left: matches at x - d,
    right: matches at x + d), in [min_disp, max_disp].
    """
    v = cfg.volume
    left_bgr = left_bgr.astype(jnp.float32)
    right_bgr = right_bgr.astype(jnp.float32)
    gray_l = bgr_to_gray(left_bgr)
    gray_r = bgr_to_gray(right_bgr)

    lvol, rvol = adgrad_bgr_volumes(left_bgr, right_bgr, v)

    g = cfg.guided
    lvol = guided_filter_volume(gray_l, lvol, g.radius, g.eps, slab=g.slab)
    rvol = guided_filter_volume(gray_r, rvol, g.radius, g.eps, slab=g.slab)

    left_raw = wta_disparity(lvol, v.min_disp)
    right_raw = wta_disparity(rvol, v.min_disp)

    left, right = left_raw, right_raw
    if denoise:
        left = variational_disparity_denoise(
            left, gray_l, v.min_disp, v.max_disp, cfg.denoise
        )
        right = variational_disparity_denoise(
            right, gray_r, v.min_disp, v.max_disp, cfg.denoise
        )

    if lr_check:
        left, right = lr_check_fill_pair(
            left, right, float(v.max_disp), float(v.min_disp)
        )

    return CostVolumeOutput(left, right, left_raw, right_raw)


def builtin_cost_volumes(rl, rr, max_disp: int, guided: bool = True):
    """Stand-in for the mc-cnn volume: AD+gradient cost, guided-filtered,
    rescaled to the mc-cnn convention (lower better, range [0, 0.5]).

    guided=False skips the guided-filter stack — the RAW adgrad volume,
    like the reference's 3DMST consumes its mc-cnn volume unfiltered
    (src/stereo_Yin.cpp:150-210). ~3x fewer volume passes (the guided
    stack is ~14 of the ~20 both-view passes); measured quality cost in
    the seeded MST composition is small (GT 240x320: epe 0.216 vs
    0.193, bad2 0.57% vs 0.20%, both far inside the battery gates;
    rectified FLIR bad2 vs SGBM 2.0% vs 2.2% — raw slightly better),
    with LR-valid coverage ~7pp lower. The throughput option; guided
    stays the quality default."""
    vcfg = CostVolumeConfig(min_disp=0, max_disp=max_disp - 1)
    bgr_l, bgr_r = rl[..., ::-1], rr[..., ::-1]
    lvol, rvol = adgrad_bgr_volumes(bgr_l, bgr_r, vcfg)
    if guided:
        g = GuidedFilterConfig()
        lvol = guided_filter_volume(bgr_to_gray(bgr_l), lvol, g.radius, g.eps, g.slab)
        rvol = guided_filter_volume(bgr_to_gray(bgr_r), rvol, g.radius, g.eps, g.slab)
    scale = 0.5 / float(vcfg.bad_cost)
    return jnp.minimum(lvol * scale, 0.5), jnp.minimum(rvol * scale, 0.5)
