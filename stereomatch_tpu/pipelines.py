"""End-to-end pipeline entry points (the package's user-facing surface).

Thin facade over `stereomatch_tpu.models`: each function takes host-side
images (numpy or jax, RGB or gray), handles layout/dtype conversion, and
returns numpy disparity maps — the equivalents of the reference's
executables (SURVEY.md §2.1): StereoTest (SGBM), the census path,
costVolumeStereoPlusVariationalDenoise, StereoYin (3DMST), and the
PatchMatch engines.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from .config import (
    CensusConfig,
    CostVolumePipelineConfig,
    SGBMConfig,
)

__all__ = [
    "check_stereo_pair",
    "costvolume_pipeline",
    "census_pipeline",
    "bm_pipeline",
    "sgbm_pipeline",
    "mst_pipeline",
    "sgbm_mst_pipeline",
    "patchmatch_pipeline",
    "to_bgr255",
]


def check_stereo_pair(left, right) -> None:
    """Validate a stereo pair (ref: StereoMatching::checkStereoPairValid,
    src/StereoMatching.cpp:4-26): both present, same spatial shape."""
    l, r = np.asarray(left), np.asarray(right)
    if l.size == 0 or r.size == 0:
        raise ValueError("stereo pair image data empty")
    if l.shape[:2] != r.shape[:2]:
        raise ValueError(f"stereo pair size mismatch: {l.shape} vs {r.shape}")


def to_bgr255(img) -> jnp.ndarray:
    """RGB/gray host image (uint8 or float) -> (H, W, 3) BGR float32 [0,255]."""
    arr = np.asarray(img)
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    if arr.dtype != np.float32:
        arr = arr.astype(np.float32)
    return jnp.asarray(arr[..., ::-1])


def _gray255(img) -> jnp.ndarray:
    arr = np.asarray(img).astype(np.float32)
    if arr.ndim == 3:
        # RGB in: BT.601 luma (matches the reference's BGR weights reversed)
        arr = 0.299 * arr[..., 0] + 0.587 * arr[..., 1] + 0.114 * arr[..., 2]
    return jnp.asarray(arr)


def costvolume_pipeline(
    left,
    right,
    cfg: CostVolumePipelineConfig = CostVolumePipelineConfig(),
    denoise: bool = True,
    lr_check: bool = False,
):
    """AD+gradient volume -> guided filter -> WTA -> Huber denoise
    (ref executable: costVolumeStereoPlusVariationalDenoise,
    src/PatchMatchStereoGPU.cu:8776-9410). Returns (left_disp, right_disp)
    as numpy float32."""
    from .models import cost_volume_stereo

    check_stereo_pair(left, right)
    out = cost_volume_stereo(to_bgr255(left), to_bgr255(right), cfg, denoise, lr_check)
    return np.asarray(out.left_disp), np.asarray(out.right_disp)


def census_pipeline(left, right, cfg: CensusConfig = CensusConfig()):
    """Ternary census + WTA right-view disparity
    (ref: StereoMatching::censusStereo, src/StereoMatching.cpp:27-114).
    Inputs gray/RGB in [0,255]; census normalizes to [0,1] internally."""
    from .ops.cost import census_stereo

    check_stereo_pair(left, right)
    l = _gray255(left) * (1.0 / 255.0)
    r = _gray255(right) * (1.0 / 255.0)
    return np.asarray(census_stereo(l, r, cfg))


def mst_pipeline(
    left,
    right,
    left_vol=None,
    right_vol=None,
    cfg=None,
    seed: int = 0,
):
    """Stereo3DMST segment-tree pipeline (ref executable: StereoYin ->
    stereo3dmst, src/Stereo3DMST.cpp:714-912). If no cost volumes are
    given, a built-in AD+gradient guided-filtered volume stands in for the
    reference's mc-cnn output. Returns (left_disp, right_disp) numpy."""
    import jax.numpy as jnp

    from .config import MSTConfig
    from .models.mst import mst_stereo

    cfg = cfg or MSTConfig()
    check_stereo_pair(left, right)
    bgr_l = to_bgr255(left)
    bgr_r = to_bgr255(right)
    if left_vol is None or right_vol is None:
        from .models.costvolume import builtin_cost_volumes

        rgb_l = jnp.asarray(np.asarray(left, np.float32))
        rgb_r = jnp.asarray(np.asarray(right, np.float32))
        left_vol, right_vol = builtin_cost_volumes(rgb_l, rgb_r, cfg.max_disp)
    out = mst_stereo(np.asarray(bgr_l), np.asarray(bgr_r), left_vol, right_vol, cfg, seed)
    return np.asarray(out.left_disp), np.asarray(out.right_disp)


def sgbm_mst_pipeline(
    left,
    right,
    left_vol=None,
    right_vol=None,
    cfg=None,
    seed: int = 0,
    fine_iterations: int | None = None,
):
    """SGBM-seeded 3DMST — the BASELINE north-star composition
    (models/sgbm_mst.py): SGBM both views, plane-fit the maps into MST
    labels, refine with a short truncated-ladder run. Returns
    (left_disp, right_disp) numpy."""
    import jax.numpy as jnp

    from .config import MSTConfig
    from .models.sgbm_mst import sgbm_mst_stereo

    cfg = cfg or MSTConfig()
    check_stereo_pair(left, right)
    bgr_l = to_bgr255(left)
    bgr_r = to_bgr255(right)
    if left_vol is None or right_vol is None:
        from .models.costvolume import builtin_cost_volumes

        rgb_l = jnp.asarray(np.asarray(left, np.float32))
        rgb_r = jnp.asarray(np.asarray(right, np.float32))
        left_vol, right_vol = builtin_cost_volumes(rgb_l, rgb_r, cfg.max_disp)
    out = sgbm_mst_stereo(
        np.asarray(bgr_l), np.asarray(bgr_r), left_vol, right_vol, cfg,
        seed=seed, fine_iterations=fine_iterations,
    )
    return np.asarray(out.left_disp), np.asarray(out.right_disp)


def patchmatch_pipeline(left, right, cfg=None, seed: int = 0, postprocess: bool = True):
    """Slanted-plane PatchMatch (ref executable: PatchMatchStereoGPU,
    src/PatchMatchStereoGPU.cu:2602-3023). Returns (left_disp, right_disp)."""
    import jax

    from .config import PatchMatchConfig
    from .models.patchmatch import patchmatch_pipeline as run_pm

    cfg = cfg or PatchMatchConfig()
    check_stereo_pair(left, right)
    out = run_pm(
        jax.random.PRNGKey(seed), to_bgr255(left), to_bgr255(right), cfg,
        postprocess=postprocess,
    )
    return np.asarray(out.left_disp), np.asarray(out.right_disp)


def bm_pipeline(left, right, cfg=None, speckle: bool = True):
    """StereoBM left-view disparity with the OpenCV parameter surface
    (ref: the legacy CLI's bm algorithm, src/stereo_opencv (copy).cpp:258-268,
    and StereoMatching::BMStereo, src/StereoMatching.cpp:116-146).
    Returns float32 disparity; invalid pixels = cfg.min_disp - 1."""
    from .config import BMConfig
    from .ops.bm import bm_disparity

    cfg = cfg or BMConfig()
    check_stereo_pair(left, right)
    out = bm_disparity(_gray255(left), _gray255(right), cfg)
    disp = np.asarray(out.disparity)
    if speckle and cfg.speckle_window_size > 0:
        from .ops.speckle import filter_speckles

        # StereoBM::compute, like SGBM, passes DISP_SCALE*speckleRange on
        # its fixed-point map = speckleRange whole disparities
        disp = np.asarray(
            filter_speckles(
                jnp.asarray(disp),
                invalid=float(cfg.min_disp - 1),
                max_size=cfg.speckle_window_size,
                max_diff=float(cfg.speckle_range),
            )
        )
    return disp


def sgbm_pipeline(left, right, cfg: SGBMConfig = SGBMConfig(), speckle: bool = True):
    """8-path SGBM left-view disparity with the OpenCV parameter surface
    (ref: StereoMatching::SGBMStereo, src/StereoMatching.cpp:148-193).
    Returns float32 disparity; invalid pixels = cfg.min_disp - 1."""
    from .ops.sgbm import sgbm_disparity, sgbm_disparity_banded

    check_stereo_pair(left, right)
    gl, gr = _gray255(left), _gray255(right)
    # band-stream when the aggregated volume would be heavy (> ~2 GB f32):
    # identical results, bounded memory
    if gl.shape[0] * gl.shape[1] * cfg.num_disp * 4 > 2 << 30:
        out = sgbm_disparity_banded(gl, gr, cfg)
    else:
        out = sgbm_disparity(gl, gr, cfg)
    disp = np.asarray(out.disparity)
    if speckle and cfg.speckle_window_size > 0:
        from .ops.speckle import filter_speckles

        # OpenCV's StereoSGBM::compute calls filterSpeckles with
        # DISP_SCALE*speckleRange on the 1/16 fixed-point map — i.e.
        # speckleRange WHOLE disparities on a float map.
        disp = np.asarray(
            filter_speckles(
                jnp.asarray(disp),
                invalid=float(cfg.min_disp - 1),
                max_size=cfg.speckle_window_size,
                max_diff=float(cfg.speckle_range),
            )
        )
    return disp
