"""SGBM-seeded 3DMST (models/sgbm_mst.py, mst_stereo_seeded).

The north-star composition (BASELINE.md: end-to-end SGBM+3DMST) as an
actual pipeline: the SGBM maps seed the MST plane labels and the
optimizer runs only a short truncated-ladder refinement. Quality is
gated ABSOLUTELY on the procedural GT battery — gating the seeded run
against the SGBM cross-oracle would be circular.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from stereomatch_tpu.eval import disparity_metrics
from stereomatch_tpu.synthetic import render_scene, scene_eval_mask


@pytest.fixture(scope="module")
def half_scene():
    sc = render_scene(1, 240, 320, 32)
    return sc, scene_eval_mask(sc)


def test_refine_deltas_truncated_ladder():
    """start=2.0 enters the reference's (d, n) schedule further down:
    same pairs as the tail of the full ladder (src/Stereo3DMST.cpp:584-625
    halves both deltas together from (Dmax/2, 1))."""
    from stereomatch_tpu.ops.mst import refine_deltas

    d_full, n_full = refine_deltas(128)
    d_cut, n_cut = refine_deltas(128, start=2.0)
    assert d_cut.shape[0] < d_full.shape[0]
    np.testing.assert_allclose(np.asarray(d_cut), np.asarray(d_full[-d_cut.shape[0]:]))
    np.testing.assert_allclose(np.asarray(n_cut), np.asarray(n_full[-d_cut.shape[0]:]))
    assert float(d_cut[0]) == 2.0 and abs(float(n_cut[0]) - 2.0 / 64.0) < 1e-7


def test_plane_labels_from_disparity_exact_plane():
    """A planar disparity image seeds labels that reproduce it exactly in
    the interior (box smoothing and central differences are exact on a
    linear field; the reflect-101 pad pulls only the smooth_radius-wide
    border band, bounded by radius * |gradient|)."""
    from stereomatch_tpu.config import MSTConfig
    from stereomatch_tpu.models.mst import build_view_forest
    from stereomatch_tpu.ops.mst import labels_to_disparity, plane_labels_from_disparity

    h, w, md = 40, 56, 32
    rng = np.random.default_rng(0)
    img = (rng.random((h, w, 3)) * 255).astype(np.float32)
    cfg = MSTConfig(max_disp=md, min_cc_size=20, c=500.0)
    fa = build_view_forest(img, cfg)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    d_true = 0.25 * xs - 0.1 * ys + 12.0
    a, b, c = plane_labels_from_disparity(jnp.asarray(d_true), fa)
    d_back = np.asarray(labels_to_disparity(a, b, c, fa, md)) * (md - 1.0)
    want = np.clip(d_true, 0, md - 1)
    np.testing.assert_allclose(d_back[3:-3, 3:-3], want[3:-3, 3:-3], atol=1e-3)
    np.testing.assert_allclose(d_back, want, atol=0.5)


@pytest.mark.parametrize("right_seed", ["mirror", "disp2"])
def test_sgbm_seed_right_view(half_scene, right_seed):
    """The right-view SGBM seed matches the scene's exact right-view GT
    where the fill didn't have to invent values — both via the mirror
    trick (a second SGBM) and via the FREE disp2 min-cost projection the
    disp12 check builds anyway (integer-valued, so its gate is the
    rounding bound)."""
    from stereomatch_tpu.config import SGBMConfig
    from stereomatch_tpu.models.sgbm_mst import sgbm_seed_disparities

    sc, m = half_scene
    dl, dr = sgbm_seed_disparities(
        sc.left, sc.right, SGBMConfig(min_disp=0, num_disp=32, block_size=5),
        right_seed=right_seed,
    )
    mm_l = disparity_metrics(np.asarray(dl), sc.disp_left, m)
    # right-view eval away from borders (no eval mask exists for it)
    mr = np.ones_like(m)
    mr[:, :40] = False
    mr[:8] = mr[-8:] = False
    mm_r = disparity_metrics(np.asarray(dr), sc.disp_right, mr)
    assert mm_l["epe"] < 1.0, mm_l
    assert mm_r["epe"] < (1.2 if right_seed == "disp2" else 1.0), mm_r
    assert mm_r["bad2"] < 0.08, mm_r


def test_sgbm_mst_fused_matches_unfused_device():
    """sgbm_mst_stereo_fused (SGBM + fill + plane seed + device forest +
    truncated-ladder optimization as ONE jitted program) follows the same
    RNG stream and stages as the unfused composition with
    forest_backend="device" — agreement up to fp-tie label flips."""
    from stereomatch_tpu.config import MSTConfig
    from stereomatch_tpu.models.sgbm_mst import (
        sgbm_mst_stereo,
        sgbm_mst_stereo_fused,
    )

    rng = np.random.default_rng(9)
    h, w, d = 48, 64, 16
    bgr_l = rng.random((h, w, 3)).astype(np.float32) * 255
    for _ in range(2):
        bgr_l = (bgr_l + np.roll(bgr_l, 1, 0) + np.roll(bgr_l, 1, 1)) / 3
    bgr_r = np.roll(bgr_l, -3, axis=1)
    vol_l = (rng.random((h, w, d)) * 0.5).astype(np.float32)
    vol_r = (rng.random((h, w, d)) * 0.5).astype(np.float32)
    cfg = MSTConfig(
        max_disp=d, iterations=8, min_cc_size=20, c=800.0,
        forest_backend="device",
    )
    out_u = sgbm_mst_stereo(bgr_l, bgr_r, vol_l, vol_r, cfg, seed=0,
                            fine_iterations=3, max_neighbors=4)
    out_f = sgbm_mst_stereo_fused(bgr_l, bgr_r, vol_l, vol_r, cfg, seed=0,
                                  fine_iterations=3, max_neighbors=4)
    du, df = np.asarray(out_u.right_disp), np.asarray(out_f.right_disp)
    assert (np.abs(du - df) < 0.1).mean() > 0.95
    cu, cf = np.asarray(out_u.left_disp), np.asarray(out_f.left_disp)
    assert (np.abs(cu - cf) < 0.1).mean() > 0.95


def test_sgbm_mst_absolute_gt(half_scene):
    """The composed pipeline at a SMALL refinement budget (4 iterations,
    ladder from 2 px) meets the same absolute gates as flat-30 mst_stereo
    in test_gt_battery.py — the measured headroom is ~2x (PARITY.md)."""
    from stereomatch_tpu.config import CostVolumeConfig, MSTConfig
    from stereomatch_tpu.models.sgbm_mst import sgbm_mst_stereo
    from stereomatch_tpu.ops.cost import adgrad_bgr_volumes

    sc, m = half_scene
    lv, rv = adgrad_bgr_volumes(
        sc.left, sc.right, CostVolumeConfig(min_disp=0, max_disp=31)
    )
    lv, rv = np.asarray(lv), np.asarray(rv)
    s = 0.5 / max(lv.max(), rv.max())
    out = sgbm_mst_stereo(
        sc.left, sc.right, lv * s, rv * s,
        MSTConfig(max_disp=32, iterations=30, min_cc_size=100, c=2000.0),
        seed=0, fine_iterations=4, max_neighbors=4,
    )
    valid = np.asarray(out.left_valid) & m
    assert valid.mean() > 0.35
    mm = disparity_metrics(np.asarray(out.left_disp), sc.disp_left, valid)
    assert mm["epe"] < 1.2, mm
    assert mm["bad2"] < 0.08, mm


def test_sgbm_mst_production_config_gt(half_scene):
    """The PRODUCTION recipe (config.production_mst_config: carry_iters=1,
    bf16 volume; call-site defaults max_neighbors=2 + truncated ladder)
    meets the same absolute gates — and measured slightly BETTER than the
    mn=4/ci=2 configuration at half scale, VGA scale AND on the rectified
    FLIR pair (PARITY.md production-config table): with a good seed the
    extra neighbor candidates and the second carry round buy nothing.
    carry_iters=1 leaves only paths crossing >= 2 segment cuts
    unaggregated, weight <= e^{-2*delta} ~ 3e-4 — at the fp32 noise floor
    of the exp-factorized aggregation itself (ops/mst.py::tree_filter)."""
    from stereomatch_tpu.config import CostVolumeConfig, production_mst_config
    from stereomatch_tpu.models.sgbm_mst import sgbm_mst_stereo
    from stereomatch_tpu.ops.cost import adgrad_bgr_volumes

    sc, m = half_scene
    lv, rv = adgrad_bgr_volumes(
        sc.left, sc.right, CostVolumeConfig(min_disp=0, max_disp=31)
    )
    lv, rv = np.asarray(lv), np.asarray(rv)
    s = 0.5 / max(lv.max(), rv.max())
    cfg = production_mst_config(
        32, iterations=30, min_cc_size=100, c=2000.0
    )
    assert cfg.carry_iters == 1 and cfg.volume_dtype == "bfloat16"
    out = sgbm_mst_stereo(
        sc.left, sc.right, lv * s, rv * s, cfg, seed=0, fine_iterations=4
    )
    valid = np.asarray(out.left_valid) & m
    assert valid.mean() > 0.35
    mm = disparity_metrics(np.asarray(out.left_disp), sc.disp_left, valid)
    assert mm["epe"] < 1.2, mm  # measured 0.216 (mn=4/ci=2: 0.225)
    assert mm["bad2"] < 0.08, mm  # measured 0.0057 (mn=4/ci=2: 0.0065)
