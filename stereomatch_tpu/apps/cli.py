"""Legacy-style stereo CLI (the reference's full command-line tool,
src/stereo_opencv (copy).cpp:47-349: --algorithm / --blocksize /
--max-disparity / --scale / -i / -e / -o / -p), extended with this
framework's additional engines.

Algorithms:
  bm        block matching with the full cv::StereoBM parameter surface:
            x-Sobel prefilter, window SAD, textureThreshold, uniqueness,
            disp12 and speckle post (src/stereo_opencv (copy).cpp:258-268,
            src/StereoMatching.cpp BMStereo)
  sgbm|hh|sgbm3way
            semi-global matching; hh = full 8-path (MODE_HH, the reference's
            production setting); sgbm/sgbm3way = the 5-direction
            single-pass set (cv2 MODE_SGBM parity ~0.05% D1)
  census    ternary census + WTA (src/StereoMatching.cpp:27-114)
  costvolume
            AD+gradient volume + guided filter + WTA + Huber denoise
            (costVolumeStereoPlusVariationalDenoise)
  mst       Stereo3DMST segment-tree pipeline (src/Stereo3DMST.cpp)
  sgbm_mst  SGBM-seeded 3DMST — the BASELINE north-star composition as
            one pipeline (models/sgbm_mst.py)
  pm        slanted-plane PatchMatch (src/pm.cpp adgrad metric + LR/fill/
            median post; src/PatchMatchStereoGPU.cu:2602-3023)
  coupled   coupled PatchMatch<->Huber-ROF alternation over the built-in
            cost volume (the reference's Family-E scheme, live —
            models/coupled.py)

Outputs: -o disparity PNG, -p point cloud (.ply/.pcd/.xyz), requires -i
(intrinsics+extrinsics FileStorage) for rectification/reprojection unless
--no-rectify.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("left")
    ap.add_argument("right")
    ap.add_argument("--algorithm", default="hh",
                    choices=["bm", "sgbm", "hh", "sgbm3way", "census",
                             "costvolume", "mst", "sgbm_mst", "pm",
                             "coupled"])
    ap.add_argument("--blocksize", type=int, default=None,
                    help="matching block size (default: 5 for sgbm modes, "
                         "9 for bm, like the reference CLI)")
    ap.add_argument("--max-disparity", type=int, default=128)
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("-i", "--calib", default=None,
                    help="FileStorage with M1,D1,M2,D2,R,T (XML/YAML)")
    ap.add_argument("-o", "--disparity-out", default=None)
    ap.add_argument("-p", "--cloud-out", default=None)
    ap.add_argument("--no-rectify", action="store_true")
    a = ap.parse_args(argv)
    if a.blocksize is not None and (a.blocksize < 1 or a.blocksize % 2 == 0):
        ap.error(f"--blocksize must be a positive odd number, got {a.blocksize}")

    import jax.numpy as jnp

    from ..io import load_image, save_disparity_png
    from ..utils import StageTimer

    timer = StageTimer(verbose=True)
    left = load_image(a.left)
    right = load_image(a.right)
    if a.scale != 1.0:
        step = int(round(1.0 / a.scale))
        left, right = left[::step, ::step], right[::step, ::step]
    h, w = left.shape[:2]

    geom = None
    if a.calib and not a.no_rectify:
        from ..geometry import rectified_geometry, remap_bilinear
        from ..io import load_stereo_calibration

        cal = load_stereo_calibration(a.calib)
        if a.scale != 1.0:
            cal = cal.rescaled(a.scale)
        geom = rectified_geometry(cal, (w, h))
        with timer.stage("rectify"):
            left = np.asarray(
                remap_bilinear(jnp.asarray(left.astype(np.float32)),
                               jnp.asarray(geom.map1x), jnp.asarray(geom.map1y))
            )
            right = np.asarray(
                remap_bilinear(jnp.asarray(right.astype(np.float32)),
                               jnp.asarray(geom.map2x), jnp.asarray(geom.map2y))
            )

    def gray(img):
        img = np.asarray(img, np.float32)
        return (0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]
                if img.ndim == 3 else img)

    nd = a.max_disparity
    if a.algorithm in ("sgbm", "hh", "sgbm3way"):
        from ..config import SGBMConfig
        from ..ops.sgbm import sgbm_disparity

        cfg = SGBMConfig(
            min_disp=0,
            num_disp=nd,
            block_size=5 if a.blocksize is None else a.blocksize,
            num_paths=8 if a.algorithm == "hh" else 5,
        )
        with timer.stage("sgbm"):
            disp = np.asarray(
                sgbm_disparity(jnp.asarray(gray(left)), jnp.asarray(gray(right)), cfg).disparity
            )
    elif a.algorithm == "bm":
        from ..config import BMConfig
        from ..pipelines import bm_pipeline

        cfg = BMConfig(
            min_disp=0,
            num_disp=nd,
            block_size=9 if a.blocksize is None else a.blocksize,
            # the rectification valid-pixel ROIs, like the reference's
            # bm->setROI1/2 (src/stereo_opencv (copy).cpp:258-268)
            roi1=geom.roi1 if geom is not None else None,
            roi2=geom.roi2 if geom is not None else None,
        )
        with timer.stage("bm"):
            disp = bm_pipeline(left, right, cfg)
    elif a.algorithm == "census":
        from ..config import CensusConfig
        from ..pipelines import census_pipeline

        disp = census_pipeline(left, right, CensusConfig(d_max=nd - 1)).astype(np.float32)
    elif a.algorithm == "costvolume":
        from ..config import CostVolumeConfig, CostVolumePipelineConfig
        from ..pipelines import costvolume_pipeline

        cfg = CostVolumePipelineConfig(
            volume=CostVolumeConfig(min_disp=0, max_disp=nd - 1)
        )
        with timer.stage("costvolume"):
            disp, _ = costvolume_pipeline(left, right, cfg, lr_check=True)
    elif a.algorithm == "pm":
        from ..config import PatchMatchConfig
        from ..pipelines import patchmatch_pipeline

        cfg = PatchMatchConfig(
            max_disp=float(nd - 1), iterations=10, metric="adgrad"
        )
        with timer.stage("pm"):
            disp, _ = patchmatch_pipeline(left, right, cfg)
    elif a.algorithm == "coupled":
        from ..config import CoupledConfig
        from ..models.coupled import coupled_patchmatch_stereo
        from ..pipelines import to_bgr255
        from ..models.costvolume import builtin_cost_volumes
        import jax

        with timer.stage("coupled"):
            lvol, _ = builtin_cost_volumes(
                jnp.asarray(np.asarray(left, np.float32)),
                jnp.asarray(np.asarray(right, np.float32)),
                nd,
            )
            out = coupled_patchmatch_stereo(
                jax.random.PRNGKey(0), to_bgr255(left), lvol,
                CoupledConfig(max_disp=nd - 1),
            )
        disp = np.asarray(out.smoothed)
    else:  # mst / sgbm_mst
        from ..config import MSTConfig
        from ..models.mst import mst_stereo
        from ..models.sgbm_mst import sgbm_mst_stereo
        from ..models.costvolume import builtin_cost_volumes

        bgr_l = jnp.asarray(np.asarray(left, np.float32)[..., ::-1])
        bgr_r = jnp.asarray(np.asarray(right, np.float32)[..., ::-1])
        with timer.stage(a.algorithm):
            lvol, rvol = builtin_cost_volumes(
                jnp.asarray(np.asarray(left, np.float32)),
                jnp.asarray(np.asarray(right, np.float32)),
                nd,
            )
            if a.algorithm == "sgbm_mst":
                # the north-star composition: SGBM seeds the MST planes
                out = sgbm_mst_stereo(
                    np.asarray(bgr_l), np.asarray(bgr_r), lvol, rvol,
                    MSTConfig(max_disp=nd),
                )
            else:
                out = mst_stereo(
                    np.asarray(bgr_l), np.asarray(bgr_r), lvol, rvol,
                    MSTConfig(max_disp=nd),
                )
        disp = np.asarray(out.left_disp)

    print(timer.report())
    if a.disparity_out:
        save_disparity_png(a.disparity_out, disp, max_disp=nd)
        print(f"wrote {a.disparity_out}")
    if a.cloud_out:
        if geom is None:
            print("point cloud needs -i calibration", file=sys.stderr)
            return 1
        from ..geometry import reproject_image_to_3d
        from ..io import filter_cloud, save_pcd, save_ply, save_xyz

        xyz = np.asarray(reproject_image_to_3d(jnp.asarray(disp), geom.Q))
        pts, cols = filter_cloud(xyz, np.asarray(left))
        if a.cloud_out.endswith(".ply"):
            save_ply(a.cloud_out, pts, cols)
        elif a.cloud_out.endswith(".pcd"):
            save_pcd(a.cloud_out, pts, cols)
        else:
            save_xyz(a.cloud_out, pts)
        print(f"wrote {a.cloud_out} ({len(pts)} pts)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
