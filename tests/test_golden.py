"""Comparison against the reference's committed output artifacts
(build/left_disparity.png — the de-facto goldens, SURVEY.md §4) and the
eval metric functions."""

import numpy as np
import pytest

from conftest import REFERENCE

from stereomatch_tpu.eval import (
    bad_pixel_rate,
    d1_all,
    disparity_metrics,
    epe,
    load_golden_png,
)


def test_metrics_basics(rng):
    gt = (rng.random((10, 12)) * 50 + 1).astype(np.float32)
    est = gt.copy()
    est[0, 0] += 10.0  # one bad pixel
    m = disparity_metrics(est, gt)
    n = gt.size
    assert abs(m["bad3"] - 1.0 / n) < 1e-6
    assert m["d1_all"] == pytest.approx(1.0 / n, abs=1e-6)
    assert m["epe"] == pytest.approx(10.0 / n, rel=1e-5)
    assert bad_pixel_rate(est, gt, 20.0) == 0.0
    assert epe(gt, gt) == 0.0
    assert d1_all(gt, gt) == 0.0


@pytest.mark.requires_reference
def test_reference_golden_loads_but_is_saturated():
    """The reference's committed left_disparity.png (written by its pm
    path, stereo_opencv.cpp:167-168, MAX_DISPARITY=60 at full resolution)
    is NOT a usable quantitative golden: the FLIR scene's true disparity
    range extends to ~250 px at 2048x1536 (verified against cv2.StereoSGBM
    with numDisparities=256 — see tests/test_sgbm.py, which is this
    framework's quantitative oracle), so the pm artifact is range-saturated.
    This test pins the loader and documents that finding."""
    golden = load_golden_png(f"{REFERENCE}/build/left_disparity.png")
    assert golden.shape == (1536, 2048)
    assert golden.max() <= 255.0 and golden.min() >= 0.0
    # heavily skewed toward the top of its 8-bit range = saturation
    assert np.median(golden) > 128.0
