import os
import tempfile

import numpy as np
import pytest

from stereomatch_tpu.io import (
    StereoCalibration,
    clean_mccnn,
    filter_cloud,
    load_filestorage,
    load_image,
    load_mccnn_volume,
    save_disparity_png,
    save_image,
    save_mccnn_volume,
    save_pcd,
    save_ply,
    to_gray,
)

REF = "/root/reference"


@pytest.mark.requires_reference
class TestCalibration:
    def test_yaml_pheno(self):
        d = load_filestorage(f"{REF}/cam_stereo_pheno.yml")
        for k in ["M1", "D1", "M2", "D2", "R", "T", "R1", "R2", "P1", "P2", "Q"]:
            assert k in d, k
        assert d["M1"].shape == (3, 3)
        assert d["Q"].shape == (4, 4)
        # fx of M1 from the file
        assert abs(d["M1"][0, 0] - 1207.6273980335018) < 1e-6
        assert abs(d["R"][0, 0] - 0.99998874673297511) < 1e-12

    def test_xml_flir(self):
        d = load_filestorage(f"{REF}/FLIR_stereo_para.xml")
        assert d["M1"].shape == (3, 3)
        assert abs(d["M1"][0, 0] - 742.54069457450657) < 1e-6
        assert d["D1"].size == 14  # rational distortion model

    def test_matches_cv2(self):
        cv2 = pytest.importorskip("cv2")
        for path in [f"{REF}/cam_stereo_pheno.yml", f"{REF}/FLIR_stereo_para.xml"]:
            ours = load_filestorage(path)
            fs = cv2.FileStorage(path, cv2.FILE_STORAGE_READ)
            for k in ["M1", "D1", "M2", "D2", "R", "T"]:
                theirs = fs.getNode(k).mat()
                np.testing.assert_allclose(
                    np.asarray(ours[k]).reshape(theirs.shape), theirs, rtol=0, atol=0
                )
            fs.release()

    def test_stereo_calibration_wrapper(self):
        cal = StereoCalibration.from_file(f"{REF}/cam_stereo_pheno.yml")
        assert cal.T.shape == (3,)
        assert cal.Q is not None
        q2 = cal.scaled_q(0.5)
        np.testing.assert_allclose(q2[:3, 3], cal.Q[:3, 3] * 0.5)
        np.testing.assert_allclose(q2[3], cal.Q[3])


class TestImages:
    @pytest.mark.requires_reference
    def test_load_flir(self):
        img = load_image(f"{REF}/build/000020_191400042.jpg")
        assert img.shape == (1536, 2048, 3)
        assert img.dtype == np.float32
        assert 0 <= img.min() and img.max() <= 255

    @pytest.mark.requires_reference
    def test_gray_matches_cv2(self):
        cv2 = pytest.importorskip("cv2")
        img = load_image(f"{REF}/build/000020_191400042.jpg")[::8, ::8]
        ours = to_gray(img)
        theirs = cv2.cvtColor(img.astype(np.uint8), cv2.COLOR_RGB2GRAY)
        assert np.abs(ours - theirs).max() <= 1.0  # rounding only

    def test_save_roundtrip(self, tmp_path):
        img = (np.random.default_rng(0).random((16, 24, 3)) * 255).astype(np.float32)
        p = str(tmp_path / "x.png")
        save_image(p, img)
        back = load_image(p)
        np.testing.assert_allclose(back, np.round(img), atol=0.5)

    def test_save_disparity(self, tmp_path):
        disp = np.linspace(0, 100, 64, dtype=np.float32).reshape(8, 8)
        p = str(tmp_path / "d.png")
        save_disparity_png(p, disp, max_disp=100)
        back = load_image(p, gray=True)
        assert back.max() > 250


class TestCostVolume:
    def test_roundtrip(self, tmp_path):
        rng = np.random.default_rng(1)
        vol = rng.random((6, 8, 4)).astype(np.float32)
        p = str(tmp_path / "left.bin")
        save_mccnn_volume(p, vol)
        raw = np.fromfile(p, dtype=np.float32)
        assert raw.size == 6 * 8 * 4
        # file layout is (D, H, W) like the reference mmap
        np.testing.assert_allclose(raw.reshape(4, 6, 8)[2], vol[:, :, 2])
        back = load_mccnn_volume(p, 6, 8, 4)
        np.testing.assert_allclose(back, vol)

    def test_clean_acrt(self):
        vol = np.array([[[0.1, np.nan, 0.9]]], dtype=np.float32)
        out = np.asarray(clean_mccnn(vol, "acrt"))
        np.testing.assert_allclose(out, [[[0.1, 0.5, 0.5]]])

    def test_clean_fast(self):
        vol = np.array([[[-1.0, 0.0, np.nan]]], dtype=np.float32)
        out = np.asarray(clean_mccnn(vol, "fast"))
        np.testing.assert_allclose(out, [[[0.0, 0.5, 0.5]]])


class TestPointCloud:
    def test_filter_and_save(self, tmp_path):
        xyz = np.zeros((4, 4, 3), np.float32)
        xyz[0, 0] = [np.inf, 0, 0]
        xyz[1, 1] = [0, 0, 2.0]
        xyz[2, 2] = [0.1, 0.1, 0.5]
        rgb = np.full((4, 4, 3), 128)
        pts, cols = filter_cloud(xyz, rgb, z_max=0.8)
        assert len(pts) == 15 - 1  # inf dropped, z=2 dropped
        save_ply(str(tmp_path / "c.ply"), pts, cols)
        save_pcd(str(tmp_path / "c.pcd"), pts, cols)
        txt = (tmp_path / "c.ply").read_text()
        assert f"element vertex {len(pts)}" in txt
        txt = (tmp_path / "c.pcd").read_text()
        assert f"POINTS {len(pts)}" in txt


def test_kitti_disparity_uint16_roundtrip(tmp_path):
    """Synthetic KITTI disp_occ format (uint16 PNG, d = value/256, 0 =
    invalid) survives a PNG round-trip through eval.load_kitti_disparity."""
    from PIL import Image

    from stereomatch_tpu.eval import load_kitti_disparity

    rng = np.random.default_rng(3)
    d_true = rng.uniform(0.5, 192.0, size=(37, 53)).astype(np.float32)
    valid_true = rng.random((37, 53)) > 0.3
    raw = np.where(valid_true, np.round(d_true * 256.0), 0).astype(np.uint16)
    p = os.path.join(tmp_path, "disp.png")
    Image.fromarray(raw, mode="I;16").save(p)

    d, valid = load_kitti_disparity(p)
    assert d.shape == (37, 53)
    np.testing.assert_array_equal(valid, valid_true)
    # quantization error <= 1/512
    np.testing.assert_allclose(d[valid], d_true[valid_true], atol=1.0 / 256.0)
    assert (d[~valid] == 0).all()


def test_middlebury_pfm_roundtrip():
    """Grayscale PFM (Middlebury GT format: bottom-up rows, negative scale
    = little endian, inf = invalid) survives a write/read round-trip."""
    from stereomatch_tpu.eval import load_middlebury_pfm, save_middlebury_pfm

    rng = np.random.default_rng(5)
    d = rng.uniform(0.1, 192.0, size=(23, 31)).astype(np.float32)
    d[4:7, 9:12] = np.inf  # invalid region
    with tempfile.TemporaryDirectory() as td:
        p = os.path.join(td, "disp0.pfm")
        save_middlebury_pfm(p, d)
        got, valid = load_middlebury_pfm(p)
    assert got.shape == d.shape
    assert not valid[5, 10] and valid[0, 0]
    np.testing.assert_allclose(got[valid], d[np.isfinite(d) & (d > 0)])
