"""StereoYin equivalent: rectify -> 3DMST -> clamp -> 3D point cloud.

Mirrors src/stereo_Yin.cpp:53-266: rectifies the pair from calibration,
runs the 3DMST segment-tree pipeline with Dmax=100 and 100 iterations
(stereo3dmst call at stereo_Yin.cpp:207), clamps disparity to >= clamp_min
(=10, stereo_Yin.cpp:226-236), reprojects with Q and writes the cloud.

The reference shells out to mc-cnn via system() and mmaps left.bin /
right.bin (Stereo3DMST.cpp:742-775). Here:
  --mccnn-dir: read those files (the de-facto checkpoint format);
  otherwise a built-in cost volume (AD+gradient, guided-filtered and
  normalized to [0, 0.5]) stands in for the CNN cost.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..config import MSTConfig
from ..geometry import rectified_geometry, remap_bilinear, reproject_image_to_3d
from ..io import (
    clean_mccnn,
    filter_cloud,
    load_image,
    load_mccnn_volume,
    load_stereo_calibration,
    save_disparity_png,
    save_ply,
)
from ..models.costvolume import builtin_cost_volumes
from ..utils import StageTimer


def run(
    data_dir: str,
    frame_id: int,
    calib: str,
    out_dir: str,
    max_disp: int = 100,
    iterations: int = 100,
    scale: float = 1.0,
    mccnn_dir: str | None = None,
    mccnn_arch: str = "acrt",
    clamp_min: float = 10.0,
    verbose: bool = True,
):
    import jax.numpy as jnp

    timer = StageTimer(verbose=verbose)
    left = load_image(os.path.join(data_dir, f"{frame_id:06d}_191400042.jpg"))
    right = load_image(os.path.join(data_dir, f"{frame_id:06d}_191400039.jpg"))
    if scale != 1.0:
        step = int(round(1.0 / scale))
        left, right = left[::step, ::step], right[::step, ::step]
    h, w = left.shape[:2]

    cal = load_stereo_calibration(calib)
    if scale != 1.0:
        cal = cal.rescaled(scale)
    # alpha=0 valid-pixels-only zoom: the ACTIVE StereoYin rectification
    # (src/stereo_Yin.cpp:135 passes CALIB_ZERO_DISPARITY, 0, img_size)
    geom = rectified_geometry(cal, (w, h), alpha=0.0)
    with timer.stage("rectify"):
        rl = remap_bilinear(
            jnp.asarray(left.astype(np.float32)), jnp.asarray(geom.map1x), jnp.asarray(geom.map1y)
        )
        rr = remap_bilinear(
            jnp.asarray(right.astype(np.float32)), jnp.asarray(geom.map2x), jnp.asarray(geom.map2y)
        )

    if mccnn_dir:
        lvol = clean_mccnn(
            load_mccnn_volume(os.path.join(mccnn_dir, "left.bin"), h, w, max_disp),
            arch=mccnn_arch,
        )
        rvol = clean_mccnn(
            load_mccnn_volume(os.path.join(mccnn_dir, "right.bin"), h, w, max_disp),
            arch=mccnn_arch,
        )
    else:
        with timer.stage("cost volume"):
            lvol, rvol = builtin_cost_volumes(rl, rr, max_disp)

    from ..models.mst import mst_stereo

    cfg = MSTConfig(max_disp=max_disp, iterations=iterations)
    with timer.stage("3dmst"):
        out = mst_stereo(np.asarray(rl)[..., ::-1], np.asarray(rr)[..., ::-1], lvol, rvol, cfg)

    disp = np.maximum(np.asarray(out.left_disp), clamp_min)  # stereo_Yin.cpp:226-236
    with timer.stage("reproject"):
        xyz = np.asarray(reproject_image_to_3d(jnp.asarray(disp), geom.Q))

    os.makedirs(out_dir, exist_ok=True)
    save_disparity_png(os.path.join(out_dir, f"mst_disp_{frame_id:06d}.png"), disp)
    pts, cols = filter_cloud(xyz, np.asarray(rl), z_max=0.8)
    save_ply(os.path.join(out_dir, f"mst_cloud_{frame_id:06d}.ply"), pts, cols)
    if verbose:
        print(timer.report())
    return disp, xyz


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--data-dir", default="/root/reference/build")
    ap.add_argument("--id", type=int, default=20)
    ap.add_argument("--calib", default="/root/reference/cam_stereo_pheno.yml")
    ap.add_argument("--out-dir", default="./out")
    ap.add_argument("--max-disp", type=int, default=100)
    ap.add_argument("--iterations", type=int, default=100)
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--mccnn-dir", default=None,
                    help="directory with mc-cnn left.bin/right.bin")
    ap.add_argument("--mccnn-arch", choices=["acrt", "fast"], default="acrt")
    a = ap.parse_args()
    run(a.data_dir, a.id, a.calib, a.out_dir, a.max_disp, a.iterations,
        a.scale, a.mccnn_dir, a.mccnn_arch)


if __name__ == "__main__":
    main()
