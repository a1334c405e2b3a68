"""Streaming-sequence app: the FLIR series processed data-parallel.

The reference processes one hard-coded frame per run (stereo_opencv.cpp
loads a single id). This app runs the whole bundled sequence
(ids 20, 40, 60, 61, 80) through the SPMD cost-volume pipeline with frames
data-parallel over the mesh's "frame" axis and rows tiled over "tile"
(SURVEY.md §5 streaming-video config). On one device the mesh is 1x1.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..config import CostVolumeConfig, CostVolumePipelineConfig, GuidedFilterConfig
from ..geometry import rectified_geometry, remap_bilinear
from ..io import load_image, load_stereo_calibration, save_disparity_png
from ..utils import StageTimer

DEFAULT_IDS = (20, 40, 60, 61, 80)


def run(
    data_dir: str,
    calib: str,
    out_dir: str,
    ids=DEFAULT_IDS,
    scale: float = 0.25,
    max_disp: int = 63,
    n_frame: int | None = None,
    verbose: bool = True,
    resume: bool = False,
):
    """resume=True skips frames whose output PNG already exists — the
    streaming checkpoint/restart story (the per-frame artifacts ARE the
    checkpoints; a killed run restarts where it stopped). The reference
    has no recovery at all (SURVEY §5)."""
    import jax
    import jax.numpy as jnp

    from ..parallel import make_mesh
    from ..parallel.tiled import tiled_cost_volume_batch

    timer = StageTimer(verbose=verbose)
    if resume:
        os.makedirs(out_dir, exist_ok=True)
        remaining = [
            fid for fid in ids
            if not os.path.exists(os.path.join(out_dir, f"stream_disp_{fid:06d}.png"))
        ]
        if verbose and len(remaining) < len(ids):
            print(f"resume: {len(ids) - len(remaining)} frames already done")
        ids = tuple(remaining)
        if not ids:
            return np.zeros((0,), np.float32)
    step = int(round(1.0 / scale))
    pairs = []
    for fid in ids:
        l = load_image(os.path.join(data_dir, f"{fid:06d}_191400042.jpg"))[::step, ::step]
        r = load_image(os.path.join(data_dir, f"{fid:06d}_191400039.jpg"))[::step, ::step]
        pairs.append((l, r))
    h, w = pairs[0][0].shape[:2]

    cal = load_stereo_calibration(calib).rescaled(scale)
    geom = rectified_geometry(cal, (w, h))
    m1x, m1y = jnp.asarray(geom.map1x), jnp.asarray(geom.map1y)
    m2x, m2y = jnp.asarray(geom.map2x), jnp.asarray(geom.map2y)

    with timer.stage("rectify batch"):
        lefts = np.stack(
            [np.asarray(remap_bilinear(jnp.asarray(l.astype(np.float32)), m1x, m1y)) for l, _ in pairs]
        )
        rights = np.stack(
            [np.asarray(remap_bilinear(jnp.asarray(r.astype(np.float32)), m2x, m2y)) for _, r in pairs]
        )

    devices = jax.devices()
    nf = n_frame or max(1, min(len(ids), len(devices) // 2))
    nt = max(1, len(devices) // nf)
    mesh = make_mesh(n_tile=nt, n_frame=nf, devices=devices[: nf * nt])
    if verbose:
        print(f"mesh: frame={nf} x tile={nt} over {nf * nt} devices")

    cfg = CostVolumePipelineConfig(
        volume=CostVolumeConfig(min_disp=0, max_disp=max_disp),
        guided=GuidedFilterConfig(slab=16),
    )
    fn = tiled_cost_volume_batch(mesh, cfg)

    # pad the batch to a multiple of the frame axis; rows to tile multiple
    b = lefts.shape[0]
    pad_b = (-b) % nf
    pad_h = (-h) % nt
    lb = np.pad(lefts[..., ::-1], ((0, pad_b), (0, pad_h), (0, 0), (0, 0)))
    rb = np.pad(rights[..., ::-1], ((0, pad_b), (0, pad_h), (0, 0), (0, 0)))

    with timer.stage("pipeline batch"):
        dl, dr = fn(lb, rb)
        dl = np.asarray(dl)[:b, :h]

    os.makedirs(out_dir, exist_ok=True)
    for fid, disp in zip(ids, dl):
        save_disparity_png(
            os.path.join(out_dir, f"stream_disp_{fid:06d}.png"), disp, max_disp
        )
    if verbose:
        print(timer.report())
        print(f"wrote {len(ids)} disparity maps to {out_dir}")
    return dl


def run_mst(
    data_dir: str,
    calib: str,
    out_dir: str,
    ids=DEFAULT_IDS,
    scale: float = 0.125,
    max_disp: int = 48,
    iterations: int = 20,
    verbose: bool = True,
    resume: bool = False,
    forest_backend: str = "host",
    sgbm_seed: bool = False,
    temporal_reseed: int | None = None,
    temporal_iterations: int = 2,
    temporal_refine_start: float = 4.0,
    scene_cut_ratio: float = 0.0,
):
    """Streaming 3DMST with the host forest build OFF the critical path:
    frame N+1's forests are built by a worker thread (the ctypes C++
    builder releases the GIL) while the device optimizes frame N — after
    the first frame, the device never waits for segmentation (the
    reference builds forests inline per frame, src/Stereo3DMST.cpp:841-847,
    serializing CPU and GPU). Returns (disparities, forest_wait_seconds):
    the per-frame time spent blocked on forest futures, ~0 from frame 1 on
    when device compute dominates.

    sgbm_seed=True is the streaming north-star composition
    (models/sgbm_mst.py): SGBM both views seeds the plane labels and
    `iterations` becomes the short truncated-ladder refinement budget
    (pass e.g. 4).

    temporal_reseed (with sgbm_seed) turns on VIDEO mode: SGBM seeds only
    frame 0 (and every temporal_reseed-th frame if > 0); every other
    frame seeds from the PREVIOUS frame's refined maps, dropping the SGBM
    pass from the steady-state frame. Temporal frames run the MEASURED
    video recipe (sgbm_mst_video semantics, GT-sequence-gated in
    tests/test_mst_video.py): `temporal_iterations` (default 2 — better
    than 4 with a one-frame-stale seed) at `temporal_refine_start`
    (default 4.0 — the annealed ladder must cover the expected
    inter-frame motion in pixels; 2.0 at 3 px drift doubled bad2).
    Keyframes keep the single-frame recipe (full `iterations` budget,
    refine_start=2.0).

    scene_cut_ratio (video mode, 0 disables) arms quality-triggered
    reseed: a temporal frame whose LR-valid fraction falls below
    ratio x the last keyframe's is redone as a keyframe — the temporal
    ladder only covers video-scale motion, and the bundled FLIR ids are
    hard scene jumps (serving.VideoStreamServer has the measured
    motivation; 0.6 is the validated threshold)."""
    import time
    from concurrent.futures import ThreadPoolExecutor

    import jax
    import jax.numpy as jnp

    from ..models.costvolume import builtin_cost_volumes
    from ..config import MSTConfig
    from ..models.mst import build_view_forest
    from ..ops.mst import labels_to_disparity, mst_pms_optimize
    from ..ops.postprocess import lr_consistency
    from ..pipelines import to_bgr255

    timer = StageTimer(verbose=verbose)
    if resume:
        os.makedirs(out_dir, exist_ok=True)
        ids = tuple(
            fid for fid in ids
            if not os.path.exists(
                os.path.join(out_dir, f"stream_mst_{fid:06d}.png")
            )
        )
        if not ids:
            return np.zeros((0,), np.float32), []
    step = int(round(1.0 / scale))
    # forest_backend="device" runs segmentation + forest construction as
    # device programs (ops/device_forest.py); the lookahead thread then
    # just dispatches async device work instead of running C++
    cfg = MSTConfig(
        max_disp=max_disp, iterations=iterations,
        forest_backend=forest_backend,
    )

    cal = load_stereo_calibration(calib).rescaled(scale)
    frames = []
    with timer.stage("load+rectify"):
        geom = None
        for fid in ids:
            l = load_image(
                os.path.join(data_dir, f"{fid:06d}_191400042.jpg")
            )[::step, ::step].astype(np.float32)
            r = load_image(
                os.path.join(data_dir, f"{fid:06d}_191400039.jpg")
            )[::step, ::step].astype(np.float32)
            if geom is None:
                geom = rectified_geometry(cal, (l.shape[1], l.shape[0]))
                maps = tuple(
                    jnp.asarray(m)
                    for m in (geom.map1x, geom.map1y, geom.map2x, geom.map2y)
                )
            rl = np.asarray(remap_bilinear(jnp.asarray(l), maps[0], maps[1]))
            rr = np.asarray(remap_bilinear(jnp.asarray(r), maps[2], maps[3]))
            frames.append((np.asarray(to_bgr255(rl)), np.asarray(to_bgr255(rr))))

    def build_pair(i):
        bl, br = frames[i]
        return build_view_forest(bl, cfg), build_view_forest(br, cfg)

    disps, waits = [], []
    prev_maps = None  # (dense left, dense right) refined maps for temporal seeding
    key_frac = None  # last keyframe's LR-valid fraction (scene-cut ref)
    scene_cuts = []  # frame ids reseeded by the quality trigger
    os.makedirs(out_dir, exist_ok=True)
    with ThreadPoolExecutor(max_workers=2) as ex:
        futs = {0: ex.submit(build_pair, 0)}
        for i, fid in enumerate(ids):
            if i + 1 < len(ids):
                futs[i + 1] = ex.submit(build_pair, i + 1)  # lookahead
            t0 = time.time()
            fa_l, fa_r = futs.pop(i).result()
            waits.append(time.time() - t0)
            bl, br = frames[i]
            with timer.stage(f"frame {fid} device"):
                lv, rv = builtin_cost_volumes(
                    jnp.asarray(bl[..., ::-1]), jnp.asarray(br[..., ::-1]),
                    max_disp,
                )
                key = jax.random.PRNGKey(int(fid))
                kl, kr = jax.random.split(key)
                if sgbm_seed:
                    from ..models.mst import _seed_min_cost
                    from ..models.sgbm_mst import (
                        _default_sgbm_cfg,
                        sgbm_seed_disparities,
                    )
                    from ..ops.mst import plane_labels_from_disparity

                    span = float(max_disp - 1)
                    temporal_frame = (
                        temporal_reseed is not None
                        and prev_maps is not None
                        and not (temporal_reseed and i % temporal_reseed == 0)
                    )

                    def solve(sdl, sdr, it_i, rs_i):
                        inits = []
                        for sd, fa, vol in ((sdl, fa_l, lv), (sdr, fa_r, rv)):
                            a0, b0, c0 = plane_labels_from_disparity(
                                jnp.clip(sd, 0.0, span), fa
                            )
                            inits.append((a0, b0, c0, _seed_min_cost(
                                vol, a0, b0, c0, fa, cfg)))
                        a, b, c, _ = mst_pms_optimize(
                            kl, lv, fa_l, cfg, init_state=inits[0],
                            iterations=it_i, refine_start=rs_i,
                        )
                        dl = labels_to_disparity(a, b, c, fa_l, max_disp) * span
                        a, b, c, _ = mst_pms_optimize(
                            kr, rv, fa_r, cfg, init_state=inits[1],
                            iterations=it_i, refine_start=rs_i,
                        )
                        dr = labels_to_disparity(a, b, c, fa_r, max_disp) * span
                        return dl, dr

                    def solve_keyframe():
                        sdl, sdr = sgbm_seed_disparities(
                            bl, br, _default_sgbm_cfg(cfg)
                        )
                        return solve(sdl, sdr, None, 2.0)

                    if temporal_frame:
                        # the measured video recipe (ADVICE r3): short
                        # budget + a ladder that covers the motion
                        dl, dr = solve(*prev_maps, temporal_iterations,
                                       temporal_refine_start)
                        if scene_cut_ratio and key_frac:
                            frac = float(jnp.mean(lr_consistency(
                                dl, dr, float(max_disp), fill=False
                            )[1].astype(jnp.float32)))
                            if frac < scene_cut_ratio * key_frac:
                                # quality-triggered reseed (see
                                # serving.VideoStreamServer): the
                                # temporal ladder cannot absorb a hard
                                # scene cut — redo as keyframe
                                scene_cuts.append(fid)
                                temporal_frame = False
                                dl, dr = solve_keyframe()
                    else:
                        dl, dr = solve_keyframe()
                    prev_maps = (dl, dr)
                else:
                    temporal_frame = False
                    a, b, c, _ = mst_pms_optimize(kl, lv, fa_l, cfg)
                    dl = labels_to_disparity(a, b, c, fa_l, max_disp) * (max_disp - 1.0)
                    a, b, c, _ = mst_pms_optimize(kr, rv, fa_r, cfg)
                    dr = labels_to_disparity(a, b, c, fa_r, max_disp) * (max_disp - 1.0)
                dl, valid = lr_consistency(dl, dr, float(max_disp), fill=False)
                if not temporal_frame:  # keyframe (or reseeded frame)
                    key_frac = float(jnp.mean(valid.astype(jnp.float32)))
                dl = np.asarray(dl)
            disps.append(dl)
            save_disparity_png(
                os.path.join(out_dir, f"stream_mst_{fid:06d}.png"), dl, max_disp
            )
    if verbose:
        print(timer.report())
        print(
            "forest wait per frame (s):",
            " ".join(f"{wt:.3f}" for wt in waits),
        )
        if scene_cuts:
            print("scene cuts (reseeded frames):",
                  " ".join(f"{fid:06d}" for fid in scene_cuts))
    return np.stack(disps), waits


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--data-dir", default="/root/reference/build")
    ap.add_argument("--calib", default="/root/reference/cam_stereo_pheno.yml")
    ap.add_argument("--out-dir", default="./out")
    ap.add_argument("--scale", type=float, default=0.25)
    ap.add_argument("--max-disp", type=int, default=63)
    ap.add_argument("--engine", choices=("costvolume", "mst", "sgbm_mst"),
                    default="costvolume")
    ap.add_argument("--iterations", type=int, default=None,
                    help="mst engines: label-optimization iterations "
                    "(default 20 flat / 4 sgbm-seeded)")
    ap.add_argument("--resume", action="store_true",
                    help="skip frames whose output already exists")
    ap.add_argument("--forest-backend", choices=("host", "device"),
                    default="host",
                    help="mst engine: host C++ builder (lookahead-hidden) "
                    "or the fully on-device jitted builder")
    ap.add_argument("--temporal-reseed", type=int, default=None,
                    help="sgbm_mst engine: VIDEO mode — SGBM seeds only "
                    "frame 0 (and every N-th frame if N > 0); other "
                    "frames seed from the previous refined maps")
    ap.add_argument("--temporal-iterations", type=int, default=2,
                    help="video mode: refinement iterations on temporal "
                    "frames (measured recipe: 2)")
    ap.add_argument("--temporal-refine-start", type=float, default=4.0,
                    help="video mode: annealed-ladder entry (px) on "
                    "temporal frames — set >= expected inter-frame motion")
    ap.add_argument("--scene-cut-ratio", type=float, default=0.0,
                    help="video mode: reseed a temporal frame whose "
                    "LR-valid fraction drops below this ratio of the "
                    "last keyframe's (0 disables; 0.6 validated)")
    a = ap.parse_args()
    if a.engine in ("mst", "sgbm_mst"):
        seeded = a.engine == "sgbm_mst"
        iters = a.iterations or (4 if seeded else 20)
        run_mst(a.data_dir, a.calib, a.out_dir, scale=a.scale,
                max_disp=a.max_disp, iterations=iters, resume=a.resume,
                forest_backend=a.forest_backend, sgbm_seed=seeded,
                temporal_reseed=a.temporal_reseed,
                temporal_iterations=a.temporal_iterations,
                temporal_refine_start=a.temporal_refine_start,
                scene_cut_ratio=a.scene_cut_ratio)
    else:
        run(a.data_dir, a.calib, a.out_dir, scale=a.scale, max_disp=a.max_disp,
            resume=a.resume)


if __name__ == "__main__":
    main()
