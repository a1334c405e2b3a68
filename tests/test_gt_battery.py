"""Absolute ground-truth accuracy battery.

Every engine is gated on EPE / bad-pixel / D1 against ANALYTICALLY EXACT
subpixel ground truth from procedural scenes (stereomatch_tpu/synthetic.py:
textured slanted background plane + occluding discs, band-limited
textures, closed-form two-view z-buffer) — the in-repo falsifiable stand-in
for the BASELINE "≤1% D1 on KITTI/Middlebury" clause, independent of the
SGBM cross-oracle used by tests/test_engine_gates.py.

Gate values are ~2x the measured numbers (recorded in PARITY.md) so they
catch regressions without flaking on RNG/backend drift.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from stereomatch_tpu.eval import disparity_metrics
from stereomatch_tpu.synthetic import render_scene, scene_eval_mask


@pytest.fixture(scope="module")
def vga_scene():
    sc = render_scene(0, 480, 640, 64)
    return sc, scene_eval_mask(sc)


@pytest.fixture(scope="module")
def half_scene():
    sc = render_scene(1, 240, 320, 32)
    return sc, scene_eval_mask(sc)


def test_scene_construction_is_consistent(vga_scene):
    """The renderer's own contract: disparities in range, plausible
    occlusion fraction, and left(x,y) == interp(right, x - d, y) to within
    bicubic interpolation error on non-occluded pixels (the pair really is
    a rectified stereo rendering of the GT, not just labels)."""
    sc, m = vga_scene
    assert 2.0 <= sc.disp_left.min() and sc.disp_left.max() <= 62.0
    assert 0.005 < sc.occ_left.mean() < 0.2
    assert m.mean() > 0.5
    from scipy.ndimage import map_coordinates

    h, w = sc.disp_left.shape
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    u = xs - sc.disp_left
    errs = []
    for c in range(3):
        ri = map_coordinates(
            sc.right[..., c].astype(np.float64), [ys[m], u[m]], order=3
        )
        errs.append(np.abs(ri - sc.left[..., c][m]))
    e = np.concatenate(errs)
    assert e.mean() < 1.0, e.mean()
    assert np.percentile(e, 99) < 5.0


def test_sgbm_absolute_gt(vga_scene):
    """SGBM on exact GT: subpixel EPE and the BASELINE ≤1% D1 clause."""
    from stereomatch_tpu.config import SGBMConfig
    from stereomatch_tpu.ops.sgbm import sgbm_disparity

    sc, m = vga_scene
    gl = sc.left.mean(-1).astype(np.float32)
    gr = sc.right.mean(-1).astype(np.float32)
    out = sgbm_disparity(gl, gr, SGBMConfig(min_disp=0, num_disp=64, block_size=5))
    mm = disparity_metrics(np.asarray(out.disparity), sc.disp_left, m)
    assert mm["epe"] < 0.35, mm
    assert mm["d1_all"] < 0.01, mm  # BASELINE north-star clause, absolute


def test_bm_absolute_gt(vga_scene):
    from stereomatch_tpu.config import BMConfig
    from stereomatch_tpu.ops.bm import bm_disparity

    sc, m = vga_scene
    gl = sc.left.mean(-1).astype(np.float32)
    gr = sc.right.mean(-1).astype(np.float32)
    out = bm_disparity(gl, gr, BMConfig(num_disp=64, block_size=9))
    d = np.asarray(out.disparity)
    mm = disparity_metrics(np.where(d < 0, 0, d), sc.disp_left, m)
    assert mm["epe"] < 0.8, mm
    assert mm["d1_all"] < 0.03, mm


def test_census_absolute_gt(vga_scene):
    """Ternary census WTA (no aggregation) is the reference's crudest
    engine — the absolute gate is correspondingly loose but still bounds
    it: most pixels within 2 px of truth."""
    from stereomatch_tpu.config import CensusConfig
    from stereomatch_tpu.ops.cost import census_stereo

    sc, m = vga_scene
    gl = sc.left.mean(-1).astype(np.float32) / 255.0
    gr = sc.right.mean(-1).astype(np.float32) / 255.0
    d = np.asarray(census_stereo(gl, gr, CensusConfig(d_max=63)))
    mm = disparity_metrics(d, sc.disp_left, m)
    assert mm["epe"] < 8.0, mm
    assert mm["bad2"] < 0.30, mm


def test_costvolume_pipeline_absolute_gt(vga_scene):
    """Guided-filter cost-volume pipeline: the production GPU path's
    equivalent also meets the ≤1% D1 clause on exact GT."""
    from stereomatch_tpu.config import (
        CostVolumeConfig,
        CostVolumePipelineConfig,
        GuidedFilterConfig,
    )
    from stereomatch_tpu.models import cost_volume_stereo

    sc, m = vga_scene
    cfg = CostVolumePipelineConfig(
        volume=CostVolumeConfig(min_disp=0, max_disp=63),
        guided=GuidedFilterConfig(slab=16),
    )
    out = cost_volume_stereo(sc.left, sc.right, cfg)
    mm = disparity_metrics(np.asarray(out.left_disp), sc.disp_left, m)
    assert mm["epe"] < 0.5, mm
    assert mm["d1_all"] < 0.01, mm


def test_patchmatch_absolute_gt(half_scene):
    """Slanted-plane PatchMatch on a scene made of planes: the plane model
    is exact, so the gate is the tightest of the battery."""
    from stereomatch_tpu.config import PatchMatchConfig
    from stereomatch_tpu.ops.patchmatch import patchmatch_stereo

    sc, m = half_scene
    pl, _, _, _ = patchmatch_stereo(
        jax.random.PRNGKey(0),
        sc.left,
        sc.right,
        PatchMatchConfig(max_disp=32.0, iterations=8, tap_stride=5, metric="adgrad"),
    )
    mm = disparity_metrics(np.asarray(pl.d), sc.disp_left, m)
    assert mm["epe"] < 0.2, mm
    assert mm["bad2"] < 0.02, mm


def test_patchmatch_bf16_features_absolute_gt(half_scene):
    """feature_dtype="bfloat16" (halves plane_cost's streamed+gathered
    bytes, the dominant PatchMatch traffic) quantizes 0..255 features to
    ~1 gray level; the absolute gate shows the plane estimates stay
    subpixel on exact GT."""
    from stereomatch_tpu.config import PatchMatchConfig
    from stereomatch_tpu.ops.patchmatch import patchmatch_stereo

    sc, m = half_scene
    pl, _, _, _ = patchmatch_stereo(
        jax.random.PRNGKey(0),
        sc.left,
        sc.right,
        PatchMatchConfig(
            max_disp=32.0, iterations=8, tap_stride=5, metric="adgrad",
            feature_dtype="bfloat16",
        ),
    )
    mm = disparity_metrics(np.asarray(pl.d), sc.disp_left, m)
    assert mm["epe"] < 0.3, mm
    assert mm["bad2"] < 0.04, mm


def test_mst_absolute_gt(half_scene):
    """3DMST over the framework's own adgrad volumes (scaled into the
    mc-cnn [0, 0.5] cost convention): absolute subpixel accuracy on the
    LR-validated left view."""
    from stereomatch_tpu.config import CostVolumeConfig, MSTConfig
    from stereomatch_tpu.models.mst import mst_stereo
    from stereomatch_tpu.ops.cost import adgrad_bgr_volumes

    sc, m = half_scene
    lv, rv = adgrad_bgr_volumes(
        sc.left, sc.right, CostVolumeConfig(min_disp=0, max_disp=31)
    )
    lv, rv = np.asarray(lv), np.asarray(rv)
    s = 0.5 / max(lv.max(), rv.max())  # label_cost's out-of-range cost is 0.5
    out = mst_stereo(
        sc.left,
        sc.right,
        lv * s,
        rv * s,
        MSTConfig(max_disp=32, iterations=30, min_cc_size=100, c=2000.0),
        seed=0,
        max_neighbors=4,
    )
    valid = np.asarray(out.left_valid) & m
    assert valid.mean() > 0.35  # LR check keeps a usable fraction
    mm = disparity_metrics(np.asarray(out.left_disp), sc.disp_left, valid)
    assert mm["epe"] < 1.2, mm
    assert mm["bad2"] < 0.08, mm
