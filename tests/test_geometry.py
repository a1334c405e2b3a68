import numpy as np
import pytest

from stereomatch_tpu.geometry import (
    init_undistort_rectify_map,
    rectified_geometry,
    remap_bilinear,
    reproject_image_to_3d,
    rodrigues,
    stereo_rectify,
    undistort_points,
)
from stereomatch_tpu.io import StereoCalibration, load_stereo_calibration

from conftest import REFERENCE, require_reference

cv2 = pytest.importorskip("cv2")


def _synthetic_calibration(seed: int, size, rational: bool) -> StereoCalibration:
    """A seeded stereo rig shaped like the reference's two: a pinhole
    camera pair with OpenCV's 5 distortion coefficients (the pheno rig,
    2048x1536) or the 14-coefficient rational model with thin-prism terms
    (the FLIR rig, 1280x960; the tilt pair stays 0, which the rectifier
    does not model). Rotation of ~0.6 deg, ~12 cm baseline in mm."""
    r = np.random.default_rng(seed)
    w, h = size

    def intrinsics():
        f = w * r.uniform(1.0, 1.3)
        return np.array([
            [f, 0.0, w / 2 + r.uniform(-20, 20)],
            [0.0, f * r.uniform(0.995, 1.005), h / 2 + r.uniform(-20, 20)],
            [0.0, 0.0, 1.0],
        ])

    def distortion():
        k1, k2, k3 = r.uniform(-0.2, 0.1), r.uniform(-0.05, 0.1), r.uniform(-0.01, 0.01)
        p1, p2 = r.normal(0.0, 1e-3, 2)
        if not rational:
            return np.array([[k1, k2, p1, p2, k3]])
        k4, k5, k6 = r.uniform(-0.2, 0.1), r.uniform(-0.05, 0.05), r.uniform(-0.01, 0.01)
        s1, s2, s3, s4 = r.normal(0.0, 1e-3, 4)
        return np.array([[k1, k2, p1, p2, k3, k4, k5, k6, s1, s2, s3, s4, 0.0, 0.0]])

    M1, D1, M2, D2 = intrinsics(), distortion(), intrinsics(), distortion()
    R = rodrigues(r.normal(0.0, 0.006, 3))
    T = np.array([-r.uniform(100.0, 140.0), r.normal(0.0, 1.0), r.normal(0.0, 1.0)])
    return StereoCalibration(M1=M1, D1=D1, M2=M2, D2=D2, R=R, T=T)


@pytest.fixture(scope="module")
def pheno():
    return _synthetic_calibration(1, (2048, 1536), rational=False)


@pytest.fixture(scope="module")
def flir():
    return _synthetic_calibration(2, (1280, 960), rational=True)


@pytest.fixture(scope="module")
def stored_pheno():
    require_reference()
    return load_stereo_calibration(f"{REFERENCE}/cam_stereo_pheno.yml")


class TestRodrigues:
    def test_roundtrip(self, rng):
        for _ in range(10):
            v = rng.normal(size=3)
            R = rodrigues(v)
            np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-12)
            np.testing.assert_allclose(rodrigues(R), v, atol=1e-9)

    def test_matches_cv2(self, rng):
        v = rng.normal(size=3)
        R_cv, _ = cv2.Rodrigues(v)
        np.testing.assert_allclose(rodrigues(v), R_cv, atol=1e-12)


class TestUndistortPoints:
    @pytest.mark.parametrize("which", ["pheno", "flir"])
    def test_matches_cv2(self, which, pheno, flir, rng):
        cal = pheno if which == "pheno" else flir
        pts = rng.uniform(100, 900, size=(20, 2)).astype(np.float64)
        ours = undistort_points(pts, cal.M1, cal.D1)
        theirs = cv2.undistortPoints(pts.reshape(-1, 1, 2), cal.M1, cal.D1).reshape(-1, 2)
        np.testing.assert_allclose(ours, theirs, atol=1e-6)


class TestStereoRectify:
    @pytest.mark.parametrize(
        "which,size", [("pheno", (2048, 1536)), ("flir", (1280, 960))]
    )
    def test_matches_cv2(self, which, size, pheno, flir):
        cal = pheno if which == "pheno" else flir
        ours = stereo_rectify(cal.M1, cal.D1, cal.M2, cal.D2, size, cal.R, cal.T)
        R1, R2, P1, P2, Q, _, _ = cv2.stereoRectify(
            cal.M1, cal.D1, cal.M2, cal.D2, size, cal.R, cal.T.reshape(3, 1),
            flags=cv2.CALIB_ZERO_DISPARITY, alpha=-1,
        )
        np.testing.assert_allclose(ours.R1, R1, atol=1e-9)
        np.testing.assert_allclose(ours.R2, R2, atol=1e-9)
        np.testing.assert_allclose(ours.P1, P1, atol=1e-4)
        np.testing.assert_allclose(ours.P2, P2, atol=1e-4)
        np.testing.assert_allclose(ours.Q, Q, atol=1e-4)

    @pytest.mark.parametrize(
        "which,size", [("pheno", (2048, 1536)), ("flir", (1280, 960))]
    )
    @pytest.mark.parametrize("alpha", [-1.0, 0.0, 0.5, 1.0])
    def test_alpha_and_rois_match_cv2(self, which, size, alpha, pheno, flir):
        """Free-scaling (alpha) + valid-pixel ROIs vs the cv2 5.0 oracle:
        alpha=0 is the ACTIVE StereoYin rectification
        (/root/reference/src/stereo_Yin.cpp:135 passes
        CALIB_ZERO_DISPARITY, 0, img_size); the ROIs feed the legacy
        CLI's BM config (src/stereo_opencv (copy).cpp:258-268). ROIs are
        exact; P/Q agree to <1e-3 px at calibration scale."""
        cal = pheno if which == "pheno" else flir
        ours = stereo_rectify(
            cal.M1, cal.D1, cal.M2, cal.D2, size, cal.R, cal.T, alpha=alpha
        )
        R1, R2, P1, P2, Q, roi1, roi2 = cv2.stereoRectify(
            cal.M1, cal.D1, cal.M2, cal.D2, size, cal.R, cal.T.reshape(3, 1),
            flags=cv2.CALIB_ZERO_DISPARITY, alpha=alpha,
        )
        np.testing.assert_allclose(ours.P1, P1, atol=1e-3)
        np.testing.assert_allclose(ours.P2, P2, atol=1e-3)
        np.testing.assert_allclose(ours.Q, Q, atol=1e-3)
        assert ours.roi1 == tuple(roi1)
        assert ours.roi2 == tuple(roi2)

    @pytest.mark.requires_reference
    def test_matches_stored_pheno(self, stored_pheno):
        """The pheno YAML carries precomputed R1/R2/P1/P2/Q — check we agree
        on rotations (P/Q depend on the image size used at calibration)."""
        pheno = stored_pheno
        ours = stereo_rectify(
            pheno.M1, pheno.D1, pheno.M2, pheno.D2, (2048, 1536), pheno.R, pheno.T
        )
        np.testing.assert_allclose(ours.R1, pheno.R1, atol=1e-6)
        np.testing.assert_allclose(ours.R2, pheno.R2, atol=1e-6)


class TestUndistortRectifyMap:
    def test_matches_cv2(self, pheno):
        size = (512, 384)
        rect = stereo_rectify(
            pheno.M1, pheno.D1, pheno.M2, pheno.D2, size, pheno.R, pheno.T
        )
        mx, my = init_undistort_rectify_map(pheno.M1, pheno.D1, rect.R1, rect.P1, size)
        cmx, cmy = cv2.initUndistortRectifyMap(
            pheno.M1, pheno.D1, rect.R1, rect.P1, size, cv2.CV_32FC1
        )
        np.testing.assert_allclose(mx, cmx, atol=1e-2)
        np.testing.assert_allclose(my, cmy, atol=1e-2)


class TestRemap:
    def test_matches_cv2(self, rng):
        img = (rng.random((64, 96, 3)) * 255).astype(np.float32)
        mapx = rng.uniform(-5, 100, size=(50, 70)).astype(np.float32)
        mapy = rng.uniform(-5, 70, size=(50, 70)).astype(np.float32)
        ours = np.asarray(remap_bilinear(img, mapx, mapy))
        theirs = cv2.remap(img, mapx, mapy, cv2.INTER_LINEAR)
        np.testing.assert_allclose(ours, theirs, atol=2e-2)

    def test_gray(self, rng):
        img = (rng.random((32, 32)) * 255).astype(np.float32)
        mapx, mapy = np.meshgrid(
            np.arange(32, dtype=np.float32), np.arange(32, dtype=np.float32)
        )
        out = np.asarray(remap_bilinear(img, mapx, mapy))
        np.testing.assert_allclose(out, img, atol=1e-4)


class TestEndToEndRectification:
    def test_full_pipeline_vs_cv2(self, pheno):
        """rectified_geometry + remap on a textured frame == cv2 pipeline."""
        from stereomatch_tpu.synthetic import render_scene

        img = render_scene(3, 384, 512, 32).left
        h, w = img.shape[:2]
        geo = rectified_geometry(pheno, (w, h))
        # NB: calibration is for full-res; this still exercises identical math
        ours = np.asarray(remap_bilinear(img, geo.map1x, geo.map1y))
        R1, R2, P1, P2, Q, _, _ = cv2.stereoRectify(
            pheno.M1, pheno.D1, pheno.M2, pheno.D2, (w, h), pheno.R, pheno.T.reshape(3, 1),
            flags=cv2.CALIB_ZERO_DISPARITY, alpha=-1,
        )
        cmx, cmy = cv2.initUndistortRectifyMap(
            pheno.M1, pheno.D1, R1, P1, (w, h), cv2.CV_32FC1
        )
        theirs = cv2.remap(img, cmx, cmy, cv2.INTER_LINEAR)
        err = np.abs(ours - theirs)
        assert np.quantile(err, 0.999) < 1.0, err.max()


class TestReproject:
    def test_matches_cv2(self, pheno, rng):
        disp = rng.uniform(1, 60, size=(24, 32)).astype(np.float32)
        Q = stereo_rectify(
            pheno.M1, pheno.D1, pheno.M2, pheno.D2, (2048, 1536), pheno.R, pheno.T
        ).Q
        ours = np.asarray(reproject_image_to_3d(disp, Q))
        theirs = cv2.reprojectImageTo3D(disp, Q)
        np.testing.assert_allclose(ours, theirs, rtol=1e-4, atol=1e-5)
