"""Stereo3DMST pipeline: segment-tree aggregation with 3D plane labels.

Data-parallel equivalent of the reference's `stereo3dmst` entry point
(src/Stereo3DMST.cpp:714-912, call stack SURVEY.md §3.2):

  1. median-blur the color channels (3x3, ref :226-228), build 4-neighbor
     L1 color edge weights (:242-282);
  2. Felzenszwalb segmentation + small-component merge + per-component MST
     forest — on the HOST via the native C++ builder (native/treebuild.cpp),
     which also emits the Euler-tour arrays the device tree filter needs;
  3. 100 iterations of MST_PMS plane-label optimization for each view —
     on the device, all trees and candidates batched (ops/mst.py);
  4. disparity from labels, clamp01 * (Dmax-1) (:189-201, :900-902), then
     left-right consistency check without fill (:904).

The matching cost is any (H, W, D) cost volume: the mc-cnn file format the
reference consumes (io/costvolume.py) or one built by this framework's own
cost layer.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import MSTConfig
from ..native import build_forest, color_edge_weights
from ..ops.filters import median3x3
from ..ops.mst import (
    forest_arrays,
    labels_to_disparity,
    mst_pms_optimize,
)
from ..ops.postprocess import lr_consistency

__all__ = [
    "mst_stereo",
    "mst_stereo_c2f",
    "mst_stereo_fused",
    "mst_stereo_seeded",
    "MSTOutput",
    "build_view_forest",
]


class MSTOutput(NamedTuple):
    left_disp: jax.Array
    right_disp: jax.Array
    left_valid: jax.Array


def _next_pow2(x: int) -> int:
    return 1 << max(1, int(x - 1)).bit_length()


def build_view_forest(bgr: np.ndarray, cfg: MSTConfig):
    """Forest construction for one view (steps 1-2 above).

    cfg.forest_backend selects the exact sequential HOST builder
    (native/treebuild.cpp) or the fully on-DEVICE jitted pipeline
    (ops/device_forest.py) — the latter keeps the whole frame loop on
    the chip. Tree/adjacency capacities for the device path are bucketed
    to powers of two so recompiles only happen across size classes.
    """
    img = jnp.asarray(np.asarray(bgr, np.float32))
    if cfg.median_prefilter:
        img = median3x3(img)
    if cfg.forest_backend == "device":
        from ..ops.device_forest import (
            build_forest_device,
            device_forest_arrays,
        )

        im = img if img.ndim == 3 else img[..., None]
        wr = jnp.sum(jnp.abs(im[:, 1:] - im[:, :-1]), axis=-1)
        wd = jnp.sum(jnp.abs(im[1:] - im[:-1]), axis=-1)
        h, w = int(im.shape[0]), int(im.shape[1])
        # capacity bucket: components are >= ~min_cc_size after the merge
        # phase; 4x headroom, validated by device_forest_arrays(check=True)
        tmax = _next_pow2(max(256, 4 * (h * w) // max(cfg.min_cc_size, 1)))
        raw = build_forest_device(
            wr, wd, c=cfg.c, min_size=cfg.min_cc_size, gamma=cfg.gamma,
            delta=cfg.max_log_range, tmax=tmax, adj_cap=8 * tmax,
        )
        return device_forest_arrays(raw, h, w, tmax=tmax)
    if cfg.forest_backend != "host":
        raise ValueError(
            f"forest_backend must be 'host' or 'device', got "
            f"{cfg.forest_backend!r}"
        )
    wr, wd = color_edge_weights(np.asarray(img))
    forest = build_forest(
        wr, wd, cfg.c, cfg.min_cc_size, cfg.gamma, cfg.max_log_range
    )
    return forest_arrays(forest)


def _apply_smoothness(disp, bgr, cfg: MSTConfig):
    """Smoothness-prior refinement selected by the reference's string
    surface ("NL2TGV"/"2TGV"/"TV"/"NONE", src/PatchMatchStereoGPU.cu:6819;
    its refinement loop is dead at .cu:7328 — these are the live
    equivalents). Operates on the [0,1]-normalized disparity like the
    reference's u fields (.cu:6941-6952)."""
    prior = cfg.smoothness_prior.upper()
    if prior in ("NONE", ""):
        return disp
    span = float(cfg.max_disp - 1)
    u0 = jnp.clip(jnp.asarray(disp) / span, 0.0, 1.0)
    bgr = jnp.asarray(np.asarray(bgr, np.float32))
    if prior in ("2TGV", "TV"):
        from ..ops.tgv import TGVParams, tgv2_refine

        gray = (
            0.114 * bgr[..., 0] + 0.587 * bgr[..., 1] + 0.299 * bgr[..., 2]
        ) * (1.0 / 255.0)
        u = tgv2_refine(
            u0, gray, TGVParams(iterations=cfg.smoothness_iters),
            tgv=(prior == "2TGV"),
        )
    elif prior in ("NL2TGV", "NLTV"):
        from ..ops.nltgv import NL2TGVParams, nl2tgv_refine

        u = nl2tgv_refine(
            u0, bgr, NL2TGVParams(iterations=cfg.smoothness_iters)
        )
    else:
        raise ValueError(
            f"smoothness_prior must be NL2TGV/NLTV/2TGV/TV/NONE, got {prior!r}"
        )
    return u * span


def mst_stereo(
    left_bgr,
    right_bgr,
    left_vol,
    right_vol,
    cfg: MSTConfig = MSTConfig(),
    seed: int = 0,
    max_neighbors: int = 8,
) -> MSTOutput:
    """Run the full 3DMST pipeline on a rectified pair + cost volumes.

    left_vol/right_vol: (H, W, D) float32 matching costs (lower = better),
    e.g. a cleaned mc-cnn volume (io.costvolume.clean_mccnn). Returns
    disparities in pixels (max at cfg.max_disp - 1), LR-checked left view.
    cfg.smoothness_prior selects the optional variational refinement
    ("NL2TGV"/"2TGV"/"TV"/"NONE" — the reference's string surface).
    """
    fa_l = build_view_forest(left_bgr, cfg)
    fa_r = build_view_forest(right_bgr, cfg)
    key = jax.random.PRNGKey(seed)
    kl, kr = jax.random.split(key)

    a, b, c, _ = mst_pms_optimize(
        kl, jnp.asarray(left_vol), fa_l, cfg, max_neighbors=max_neighbors
    )
    disp_l = labels_to_disparity(a, b, c, fa_l, cfg.max_disp) * (cfg.max_disp - 1.0)

    a, b, c, _ = mst_pms_optimize(
        kr, jnp.asarray(right_vol), fa_r, cfg, max_neighbors=max_neighbors
    )
    disp_r = labels_to_disparity(a, b, c, fa_r, cfg.max_disp) * (cfg.max_disp - 1.0)

    disp_l = _apply_smoothness(disp_l, left_bgr, cfg)
    disp_r = _apply_smoothness(disp_r, right_bgr, cfg)

    disp_l_checked, valid = lr_consistency(
        disp_l, disp_r, float(cfg.max_disp), fill=False
    )
    return MSTOutput(disp_l_checked, disp_r, valid)


def _fused_capacities(h: int, w: int, cfg: MSTConfig) -> tuple[int, int]:
    tmax = _next_pow2(max(256, 4 * (h * w) // max(cfg.min_cc_size, 1)))
    return tmax, 8 * tmax


@partial(
    jax.jit,
    static_argnames=("cfg", "max_neighbors", "h", "w", "tmax", "adj_cap"),
)
def _mst_frame_fused(
    left_bgr, right_bgr, left_vol, right_vol, key, cfg: MSTConfig,
    max_neighbors: int, h: int, w: int, tmax: int, adj_cap: int,
):
    from ..ops.device_forest import build_forest_device, device_forest_arrays

    def view(bgr, vol, k):
        img = median3x3(bgr) if cfg.median_prefilter else bgr
        im = img if img.ndim == 3 else img[..., None]
        wr = jnp.sum(jnp.abs(im[:, 1:] - im[:, :-1]), axis=-1)
        wd = jnp.sum(jnp.abs(im[1:] - im[:-1]), axis=-1)
        raw = build_forest_device(
            wr, wd, c=cfg.c, min_size=cfg.min_cc_size, gamma=cfg.gamma,
            delta=cfg.max_log_range, tmax=tmax, adj_cap=adj_cap,
        )
        fa = device_forest_arrays(raw, h, w, tmax=tmax, check=False)
        a, b, c, _ = mst_pms_optimize(
            k, vol, fa, cfg, max_neighbors=max_neighbors
        )
        return labels_to_disparity(a, b, c, fa, cfg.max_disp) * (
            cfg.max_disp - 1.0
        )

    kl, kr = jax.random.split(key)
    disp_l = view(left_bgr, left_vol, kl)
    disp_r = view(right_bgr, right_vol, kr)
    return disp_l, disp_r


def mst_stereo_fused(
    left_bgr,
    right_bgr,
    left_vol,
    right_vol,
    cfg: MSTConfig = MSTConfig(),
    seed: int = 0,
    max_neighbors: int = 8,
) -> MSTOutput:
    """The ENTIRE 3DMST frame as one jitted XLA program — median prefilter,
    edge weights, segmentation, MST forest, Euler numbering, all label
    iterations, disparity and the LR check — with zero host round-trips
    between stages (requires the device forest path; same RNG stream as
    mst_stereo with forest_backend="device", tests/test_device_forest.py).
    The reference serializes CPU graph construction against GPU
    optimization per frame (src/Stereo3DMST.cpp:841-889); here the chip
    never waits on the host at all.

    The optional smoothness prior and the LR check run as (device-side)
    follow-up dispatches only because the prior's parameter surface is
    selected by string at the Python level.
    """
    h, w = int(np.asarray(left_bgr).shape[0]), int(np.asarray(left_bgr).shape[1])
    tmax, adj_cap = _fused_capacities(h, w, cfg)
    key = jax.random.PRNGKey(seed)
    disp_l, disp_r = _mst_frame_fused(
        jnp.asarray(np.asarray(left_bgr, np.float32)),
        jnp.asarray(np.asarray(right_bgr, np.float32)),
        jnp.asarray(left_vol),
        jnp.asarray(right_vol),
        key, cfg, max_neighbors, h, w, tmax, adj_cap,
    )
    disp_l = _apply_smoothness(disp_l, left_bgr, cfg)
    disp_r = _apply_smoothness(disp_r, right_bgr, cfg)
    disp_l_checked, valid = lr_consistency(
        disp_l, disp_r, float(cfg.max_disp), fill=False
    )
    return MSTOutput(disp_l_checked, disp_r, valid)


def _seed_min_cost(vol, a0, b0, c0, fa, cfg: MSTConfig):
    """TRUE aggregated cost of seed labels, so the init is sticky against
    the optimizer's per-pixel min updates (normalized consistently with
    mst_pms_optimize's comparisons when cost_norm_factor is on)."""
    from ..ops.mst import aggregation_norm_inv, label_cost, tree_filter

    mc0 = tree_filter(
        label_cost(vol, a0, b0, c0, fa, cfg.max_disp), fa, cfg.carry_iters
    )
    if cfg.normalize_aggregation:
        mc0 = mc0 * aggregation_norm_inv(fa, cfg.carry_iters)
    return mc0


def mst_stereo_seeded(
    left_bgr,
    right_bgr,
    left_vol,
    right_vol,
    seed_disp_l,
    seed_disp_r,
    cfg: MSTConfig = MSTConfig(),
    seed: int = 0,
    fine_iterations: int | None = None,
    refine_start: float | None = 2.0,
    max_neighbors: int = 2,
) -> MSTOutput:
    """3DMST seeded from per-pixel disparity maps (e.g. SGBM's output —
    models/sgbm_mst.py composes exactly that): plane labels come from the
    smoothed seed's local gradients (ops/mst.py::plane_labels_from_disparity)
    with their true aggregated cost, and the optimizer runs only a short
    refinement phase with the annealed ladder entered at `refine_start`
    pixels instead of Dmax/2.

    Beyond the reference (always 100 random-init full-ladder iterations,
    src/Stereo3DMST.cpp:858-889): on the north-star SGBM+3DMST composition
    the SGBM map exists anyway, and seeding cuts both the iteration count
    AND the per-iteration candidate count — quality gated absolutely in
    tests/test_gt_battery.py and measured in PARITY.md.
    """
    from ..ops.mst import plane_labels_from_disparity

    fi = max(2, cfg.iterations // 10) if fine_iterations is None else fine_iterations
    key = jax.random.PRNGKey(seed)
    kl, kr = jax.random.split(key)

    def view(k, bgr, vol, seed_disp):
        vol = jnp.asarray(vol)
        if cfg.volume_dtype != "float32":
            vol = vol.astype(cfg.volume_dtype)
        fa = build_view_forest(bgr, cfg)
        a0, b0, c0 = plane_labels_from_disparity(jnp.asarray(seed_disp), fa)
        mc0 = _seed_min_cost(vol, a0, b0, c0, fa, cfg)
        a, b, c, _ = mst_pms_optimize(
            k, vol, fa, cfg, max_neighbors=max_neighbors, iterations=fi,
            init_state=(a0, b0, c0, mc0), refine_start=refine_start,
        )
        return labels_to_disparity(a, b, c, fa, cfg.max_disp) * (
            cfg.max_disp - 1.0
        )

    disp_l = view(kl, left_bgr, left_vol, seed_disp_l)
    disp_r = view(kr, right_bgr, right_vol, seed_disp_r)
    disp_l = _apply_smoothness(disp_l, left_bgr, cfg)
    disp_r = _apply_smoothness(disp_r, right_bgr, cfg)
    disp_l_checked, valid = lr_consistency(
        disp_l, disp_r, float(cfg.max_disp), fill=False
    )
    return MSTOutput(disp_l_checked, disp_r, valid)


def _c2f_view(key, bgr, vol, cfg: MSTConfig, k: int, coarse_iters: int,
              fine_iters: int, max_neighbors: int):
    """Coarse-to-fine label optimization for ONE view (hierarchical
    disparity prediction in the spirit of the fast-NLS literature, e.g.
    arXiv:1509.08197 — beyond the reference, which always runs all 100
    iterations at full resolution, src/Stereo3DMST.cpp:858-889).

    A plane d = a x + b y + c at 1/k scale maps to full resolution as
    (a, b, k*c): d_f(x, y) = k * d_c(x/k, y/k). The upsampled labels seed
    the full-scale run WITH their true aggregated cost (one tree_filter
    pass), so the fine iterations only refine — the long random-search
    phase happens on a volume k^3 times smaller.
    """
    import dataclasses

    vol = jnp.asarray(vol)
    if cfg.volume_dtype != "float32":
        vol = vol.astype(cfg.volume_dtype)  # one cast shared by both scales
    h, w, d = vol.shape
    dc = max(2, -(-d // k))
    cfg_c = dataclasses.replace(cfg, max_disp=dc, iterations=coarse_iters)
    bgr_c = np.asarray(bgr)[::k, ::k]
    vol_c = vol[::k, ::k, ::k][:, :, :dc]

    kc, kf = jax.random.split(key)
    fa_c = build_view_forest(bgr_c, cfg_c)
    ac, bc, cc, _ = mst_pms_optimize(
        kc, vol_c, fa_c, cfg_c, max_neighbors=max_neighbors,
        iterations=coarse_iters,
    )
    # coarse node-order labels -> coarse pixel maps
    hc, wc = bgr_c.shape[:2]
    pix_c = fa_c.pixel_of_node
    a_img = jnp.zeros((hc * wc,)).at[pix_c].set(ac).reshape(hc, wc)
    b_img = jnp.zeros((hc * wc,)).at[pix_c].set(bc).reshape(hc, wc)
    c_img = jnp.zeros((hc * wc,)).at[pix_c].set(cc).reshape(hc, wc)

    # full-res init: each pixel takes its coarse cell's plane, rescaled
    fa = build_view_forest(bgr, cfg)
    pix = fa.pixel_of_node
    ys = jnp.clip((pix // w) // k, 0, hc - 1)
    xs = jnp.clip((pix % w) // k, 0, wc - 1)
    a0 = a_img[ys, xs]
    b0 = b_img[ys, xs]
    c0 = c_img[ys, xs] * float(k)
    mc0 = _seed_min_cost(vol, a0, b0, c0, fa, cfg)
    a, b, c, _ = mst_pms_optimize(
        kf, vol, fa, cfg, max_neighbors=max_neighbors, iterations=fine_iters,
        init_state=(a0, b0, c0, mc0),
    )
    return labels_to_disparity(a, b, c, fa, cfg.max_disp) * (cfg.max_disp - 1.0)


def mst_stereo_c2f(
    left_bgr,
    right_bgr,
    left_vol,
    right_vol,
    cfg: MSTConfig = MSTConfig(),
    seed: int = 0,
    k: int = 2,
    coarse_iterations: int | None = None,
    fine_iterations: int | None = None,
    max_neighbors: int = 8,
) -> MSTOutput:
    """Coarse-to-fine 3DMST: optimize at 1/k scale first (volume k^3 times
    smaller), upsample the plane labels, and refine at full scale with far
    fewer iterations. Defaults: coarse = cfg.iterations, fine =
    cfg.iterations // 4. Same output contract as mst_stereo.

    Worth it at PRODUCTION scale, where per-iteration cost dominates: with
    the defaults the full-scale work drops to ~(1/k^3)*coarse + fine
    full-iteration equivalents (e.g. ~14 instead of 100 at k=2). At toy
    sizes the second forest build + compile dominates and the flat run is
    faster — this is a scale feature, not a micro-benchmark win."""
    if cfg.max_disp < 2 * k:
        # too few coarse disparity slices to carry a useful landscape
        # (vol[::k] would have < 2 entries); fall back to flat optimization
        ci0 = coarse_iterations or cfg.iterations
        fi0 = fine_iterations or max(1, cfg.iterations // 4)
        import dataclasses

        return mst_stereo(
            left_bgr, right_bgr, left_vol, right_vol,
            dataclasses.replace(cfg, iterations=ci0 + fi0), seed,
            max_neighbors,
        )
    ci = cfg.iterations if coarse_iterations is None else coarse_iterations
    fi = max(1, cfg.iterations // 4) if fine_iterations is None else fine_iterations
    key = jax.random.PRNGKey(seed)
    kl, kr = jax.random.split(key)
    disp_l = _c2f_view(kl, left_bgr, left_vol, cfg, k, ci, fi, max_neighbors)
    disp_r = _c2f_view(kr, right_bgr, right_vol, cfg, k, ci, fi, max_neighbors)
    disp_l = _apply_smoothness(disp_l, left_bgr, cfg)
    disp_r = _apply_smoothness(disp_r, right_bgr, cfg)
    disp_l_checked, valid = lr_consistency(
        disp_l, disp_r, float(cfg.max_disp), fill=False
    )
    return MSTOutput(disp_l_checked, disp_r, valid)
