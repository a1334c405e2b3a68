"""Typed configuration objects for every pipeline in the framework.

The reference codebase (lr-xiang/StereoMatch) hard-codes all of its algorithm
constants inline (SGBM params `src/StereoMatching.cpp:156-173`, PatchMatch
`src/pm.cpp:4-6`, 3DMST `src/Stereo3DMST.cpp:830-832`, guided filter
`src/PatchMatchStereoGPU.cu:9000-9001`, variational denoise
`src/PatchMatchStereoGPU.cu:7860-7880`).  Here every constant lives in one
frozen (hashable) dataclass so configs can be passed as static jit arguments.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class CensusConfig:
    """Ternary census stereo (ref: src/StereoMatching.cpp:27-114).

    The reference uses a 9x17 window (win_rw=4 horizontal half-width,
    win_rh=8 vertical half-width), a 3-level census with dead-band
    ``epsilon`` on [0,1]-normalized intensities, Hamming cost and WTA over
    d in [0, d_max].
    """

    win_rw: int = 4
    win_rh: int = 8
    epsilon: float = 0.0045
    d_max: int = 50


@dataclass(frozen=True)
class BMConfig:
    """StereoBM parameter surface, mirroring cv::StereoBM as configured by
    the reference's legacy CLI (src/stereo_opencv (copy).cpp:258-268):
    preFilterCap 31, blockSize 9, minDisparity 0, textureThreshold 10,
    uniquenessRatio 15, speckle 100/32, disp12MaxDiff 1.
    """

    min_disp: int = 0
    num_disp: int = 128
    block_size: int = 9
    prefilter_cap: int = 31
    texture_threshold: int = 10
    uniqueness_ratio: int = 15
    speckle_window_size: int = 100
    speckle_range: int = 32
    disp12_max_diff: int = 1
    # rectification valid-pixel ROIs (x, y, w, h), the bm->setROI1/2 the
    # reference's legacy CLI feeds from stereoRectify
    # (src/stereo_opencv (copy).cpp:258-268). When both are set, validity
    # is restricted to cv::getValidDisparityROI(roi1, roi2, ...)
    # (ops/bm.py::valid_disparity_roi, cv2-oracle-tested). Tuples keep
    # the dataclass hashable (static jit arg).
    roi1: tuple[int, int, int, int] | None = None
    roi2: tuple[int, int, int, int] | None = None


@dataclass(frozen=True)
class SGBMConfig:
    """SGBM parameter surface, mirroring OpenCV StereoSGBM as configured by
    the reference (src/StereoMatching.cpp:148-193): blockSize 5,
    P1=8*cn*bs^2, P2=32*cn*bs^2, minDisparity 16, numDisparities 16*k,
    uniquenessRatio 10, speckle 100/32, disp12MaxDiff 1, MODE_HH (full
    8-path).
    """

    min_disp: int = 16
    num_disp: int = 256
    block_size: int = 5
    channels: int = 1
    p1: int | None = None  # default 8 * channels * block_size**2
    p2: int | None = None  # default 32 * channels * block_size**2
    prefilter_cap: int = 63
    uniqueness_ratio: int = 10
    speckle_window_size: int = 100
    speckle_range: int = 32
    disp12_max_diff: int = 1
    # 8 = MODE_HH (full 8-path, the reference's production setting);
    # 5 = MODE_SGBM's single-pass direction set {N, NW, NE, E, W}
    # (matches cv2 MODE_SGBM to D1 ~ 0.05%); 4 = plain N/S/E/W
    num_paths: int = 8  # MODE_HH
    # "float32" matches OpenCV's int16 arithmetic exactly (integer-valued
    # costs); "bfloat16" halves cost/aggregation HBM (needed for
    # 2048x1536x256-scale volumes) at the price of tie-level rounding in
    # weak-texture pixels.
    cost_dtype: str = "float32"

    def resolved_p1p2(self) -> tuple[int, int]:
        bs2 = self.block_size * self.block_size
        p1 = self.p1 if self.p1 is not None else 8 * self.channels * bs2
        p2 = self.p2 if self.p2 is not None else 32 * self.channels * bs2
        return p1, p2


@dataclass(frozen=True)
class CostVolumeConfig:
    """Pixelwise truncated AD + gradient BGR cost volume
    (ref: buildCostVolumeSharedMemoryBGR, src/PatchMatchStereoGPU.cu:1482-1550):
    cost = 0.11*min(L1color/3, 7) + 0.89*min(|d forward-gradient|, 2),
    out-of-range pixels get bad_cost. Images are local-contrast (box-mean
    subtracted) beforehand in the production pipeline
    (src/PatchMatchStereoGPU.cu:8947-8961).
    """

    min_disp: int = 0
    max_disp: int = 127
    color_truncation: float = 7.0
    gradient_truncation: float = 2.0
    bad_cost: float = 3.0
    color_weight: float = 0.11
    gradient_weight: float = 0.89
    mean_subtract_radius: int = 17  # local-contrast box radius

    @property
    def num_disp(self) -> int:
        return self.max_disp - self.min_disp + 1


@dataclass(frozen=True)
class ZNCCConfig:
    """Windowed ZNCC/AD/AGD gray cost volume
    (ref: buildCostVolumeSharedMemory, src/PatchMatchStereoGPU.cu:1298-1479).
    """

    min_disp: int = 0
    max_disp: int = 127
    win_radius: int = 4
    metric: str = "zncc"  # "zncc" | "ad" | "agd"
    bad_cost: float = 1.0


@dataclass(frozen=True)
class GuidedFilterConfig:
    """Guided-filter cost-volume smoothing (ref production constants
    eps=(0.01*255)^2, win_rad=9, src/PatchMatchStereoGPU.cu:9000-9001)."""

    radius: int = 9
    eps: float = (0.01 * 255.0) ** 2
    slab: int = 16  # disparity slices filtered per scan step (memory knob)


@dataclass(frozen=True)
class DenoiseConfig:
    """Weighted-Huber (Newcombe-style) primal-dual disparity denoise
    (ref: variationalDisparityDenoise, src/PatchMatchStereoGPU.cu:7809-7940;
    kernels :1042-1126). Constants from .cu:7860-7880: delta=gamma=0.00159,
    sigma=1/(8*0.02), tau=0.02, per-pixel weight exp(-alpha*|grad I|^beta)
    with alpha=10, beta=1; lambda=0.5 at the call site (.cu:9226-9227).
    """

    lam: float = 0.5
    delta: float = 0.00159
    gamma: float = 0.00159
    sigma: float = 1.0 / (8.0 * 0.02)
    tau: float = 0.02
    alpha: float = 10.0
    beta: float = 1.0
    iterations: int = 100


@dataclass(frozen=True)
class PatchMatchConfig:
    """Slanted-plane PatchMatch stereo.

    CPU reference (src/pm.cpp:4-6, pm.h:159-162): WINDOW_SIZE=35,
    MAX_DISPARITY=60, PLANE_PENALTY=120, adaptive weight
    w(p,q)=exp(-||dc||_1/gamma) with gamma=10 (caller), dissimilarity
    (1-alpha)*min(||dc||_1, tau_c) + alpha*min(||dgrad||_1, tau_g).
    GPU reference (src/PatchMatchStereoGPU.cu:861-998, :1740-2010).

    This build evaluates the window cost on a subsampled tap grid
    (``tap_stride``) instead of materializing the rows*cols*35*35 weight
    tensor of pm.cpp:447-487 — same trick the reference's own huber variant
    uses (window subsampled stride 5, .cu:3126-3128).
    """

    alpha: float = 0.9
    gamma: float = 10.0
    tau_c: float = 10.0
    tau_g: float = 2.0
    window_size: int = 35
    tap_stride: int = 5
    min_disp: float = 0.0
    max_disp: float = 60.0
    plane_penalty: float = 120.0
    iterations: int = 3
    refine_end_dz: float = 0.1
    # "grad_sign": the GPU kernel's active metric (sign-of-gradient census,
    # .cu:981-983); "adgrad": the CPU pm dissimilarity
    # (1-alpha)*min(L1color, tau_c) + alpha*min(L1grad, tau_g) (pm.cpp:97-104)
    metric: str = "grad_sign"
    # Storage dtype of the per-tap streamed/gathered feature maps (padded
    # color/gray/gradient images). "bfloat16" halves plane_cost's HBM
    # traffic — the dominant PatchMatch bytes.
    # Features are 0..255 so bf16 quantizes to ~1 gray level; every L1 /
    # weight / accumulation happens in f32 after the loads. Quality gated
    # on the GT battery (tests/test_gt_battery.py::test_patchmatch_bf16).
    feature_dtype: str = "float32"


@dataclass(frozen=True)
class CoupledConfig:
    """Coupled PatchMatch <-> variational engine (the reference's Family E
    data-step set: evaluateCost_huber src/PatchMatchStereoGPU.cu:3033-3271,
    stereoMatching_huber :3273-3581, huberROFSmooth :3903-4073, and the
    AL-WTA MCCNN_ALTV_CostVolumeWTA :4748-4803 with the alternation loop
    :7331-7727 — dead in the reference, live here).

    Constants cited: lambda_data=50 (.cu:3299), window stride 5
    (:3126-3128), weight gamma 255/5 on [0,1] colors = 5 on [0,255]
    (:3047), out-of-range tap cost 1.0 / weight 0.7 (:3253-3254), volume
    lerp clamp 0.5 (:3200), Huber eps 0.001 (:3938), primal/dual steps
    1/sqrt(8) (:3940,:4046). The theta coupling schedule is free in the
    reference (device globals init 0, .cu:178-179, never set on the live
    path); here it ramps linearly from theta_start to theta_end.
    """

    max_disp: int = 60
    window_size: int = 35
    tap_stride: int = 5
    gamma_pmsh: float = 5.0
    lambda_data: float = 50.0
    oob_cost: float = 1.0
    oob_weight: float = 0.7
    clamp: float = 0.5
    huber_eps: float = 0.001
    outer_iterations: int = 10
    smooth_iters: int = 10
    theta_d_start: float = 5.0
    theta_d_end: float = 50.0
    theta_n_start: float = 0.5
    theta_n_end: float = 5.0
    # AL-WTA variant (MCCNN_ALTV_CostVolumeWTA + TGV): lambda_d weights the
    # volume term; theta_inv grows by 1/(1 - beta*i) per round (.cu:7532)
    lambda_d: float = 1.0
    theta_inv0: float = 1.0
    beta_anneal: float = 0.01


@dataclass(frozen=True)
class MSTConfig:
    """Stereo3DMST: segment-tree (MST forest) cost aggregation with 3D plane
    labels (ref: src/Stereo3DMST.cpp). Constants from Stereo3DMST.cpp:830-832:
    gamma=1/12, c=5000, min_cc_size=200; Dmax=100 and 100 iterations from the
    stereo_Yin.cpp:207 call site.
    """

    gamma: float = 1.0 / 12.0
    c: float = 5000.0
    min_cc_size: int = 200
    max_disp: int = 100
    iterations: int = 100
    median_prefilter: int = 3
    # Trees are split into segments whose gamma-weighted depth range is at
    # most this bound, so the exp-factorized Euler-tour aggregation stays
    # well-conditioned in fp32 (worst-case cancellation ~ eps * e^{2*range}).
    # Cross-segment aggregation is restored by `carry_iters` rounds of carry
    # injection: paths crossing more than carry_iters cuts are dropped, and
    # such a path's weight is <= e^{-(carry_iters+1) * range} — 6e-6 at the
    # defaults (2, 4.0), already below the fp32 noise floor of the
    # aggregation itself (~eps * e^{2*range} ~ 3e-4). Each extra round
    # costs two more full Euler-prefix passes per tree_filter, so keep this
    # minimal; 5 is paranoia-level (2e-9 x cheaper passes were the round-1
    # default before the at-scale runtime was measured).
    max_log_range: float = 4.0
    carry_iters: int = 2
    # Smoothness-prior selection string, the reference's parameter surface
    # ("NL2TGV"/"2TGV"/"TV"/"NONE", src/PatchMatchStereoGPU.cu:6819 via the
    # stereo3dmst smoothness argument; its refinement loop is dead code at
    # .cu:7328 — here the refiners are live: ops/tgv.py, ops/nltgv.py
    # applied to the normalized disparity after label optimization).
    smoothness_prior: str = "NONE"
    smoothness_iters: int = 50
    # Normalized aggregation: divide the tree-filtered cost by the
    # tree-filtered ONES volume (per-pixel total support weight), the live
    # NL2TGV MST path's cost_norm_factor (ComputeMSTCostNormFactor +
    # inversion, src/PatchMatchStereoGPU.cu:5415-5429, :5919; applied at
    # :5403). The reference enables it for the right view (`true` at
    # :7117) and leaves the left at the default false; the standalone
    # Stereo3DMST.cpp never normalizes. NOTE (proved in
    # tests/test_mst.py::test_normalized_aggregation_label_invariance):
    # the factor is constant per PIXEL across candidates and iterations,
    # so pure label selection is invariant — it matters only for
    # consumers of min_cost (the AL coupling term .cu:7247, c2f seeds).
    normalize_aggregation: bool = False
    # Cost-volume storage dtype for label_cost reads. "bfloat16" halves
    # both resident volume memory and gather bytes per iteration (the
    # dominant 3DMST traffic); costs are in [0, 0.5] so bf16 adds ~2e-3
    # absolute noise, below the aggregation's own fp32 noise floor. The
    # lerp and every aggregation pass remain f32. Accuracy gated on the
    # GT battery (tests/test_gt_battery.py) and plane recovery
    # (tests/test_mst.py).
    volume_dtype: str = "float32"
    # Forest construction backend. "host": the exact sequential builder
    # (native/treebuild.cpp C++, pyforest.py fallback) — greedy top-down
    # segment splits on the host (hide it with apps/stream.py
    # lookahead). "device": ops/device_forest.py —
    # the whole segmentation -> MST -> Euler pipeline as one jitted XLA
    # program (Boruvka partition family, band-quantized segment splits
    # with the same rel_gd <= max_log_range guarantee); no host work in
    # the frame loop at all. Parity: tests/test_device_forest.py.
    forest_backend: str = "host"


def production_mst_config(max_disp: int, **overrides) -> MSTConfig:
    """The measured production recipe for 3DMST refinement in the
    SGBM-seeded composition (models/sgbm_mst.py) — every choice gated on
    the absolute-GT battery (tests/test_mst_seeded.py, PARITY.md):

    - volume_dtype="bfloat16": halves label_cost gather bytes; D1 vs f32
      = 0 at the benched shapes.
    - carry_iters=1: paths crossing >= 2 segment cuts carry weight
      <= e^{-2*max_log_range} ~ 3e-4 — at the aggregation's own fp32
      noise floor. Measured GT quality is unchanged at half AND VGA
      scale (EPE within 0.003); cuts every tree_filter from 3 to 2
      scan rounds (1/3 of the scan bytes).

    The matching candidate budget (max_neighbors=2 + the truncated
    ladder) lives at the call sites' defaults — see
    models/sgbm_mst.py::sgbm_mst_stereo. carry_iters=2 remains
    MSTConfig's default: for RANDOM-init full-ladder runs the general
    bound is the safe choice; the seeded path is where the byte budget
    is production-critical.
    """
    kw = dict(
        max_disp=max_disp,
        volume_dtype="bfloat16",
        carry_iters=1,
    )
    kw.update(overrides)
    return MSTConfig(**kw)


@dataclass(frozen=True)
class LRCheckConfig:
    """Left-right consistency check + occlusion fill
    (ref: leftRightConsistencyCheck, src/Stereo3DMST.cpp:632-710)."""

    max_diff: float = 1.0
    fill: bool = True


@dataclass(frozen=True)
class WeightedMedianConfig:
    """Color-weighted median filter (ref: pm.cpp:396-435 with 35x35 window;
    GPU 21x21 occluded-only variant .cu:2436-2600)."""

    window_size: int = 21
    gamma: float = 10.0
    tap_stride: int = 2
    bisect_iters: int = 10
    occluded_only: bool = True


@dataclass(frozen=True)
class RectifyConfig:
    """Stereo rectification (ref: cv::stereoRectify call at
    src/stereo_opencv.cpp:121 with CALIB_ZERO_DISPARITY, alpha=-1)."""

    zero_disparity: bool = True
    alpha: float = -1.0


@dataclass(frozen=True)
class SGBMPipelineConfig:
    sgbm: SGBMConfig = SGBMConfig()
    lr: LRCheckConfig = LRCheckConfig()


@dataclass(frozen=True)
class CostVolumePipelineConfig:
    """costVolumeStereoPlusVariationalDenoise pipeline config
    (ref: src/PatchMatchStereoGPU.cu:8776-9410)."""

    volume: CostVolumeConfig = CostVolumeConfig()
    guided: GuidedFilterConfig = GuidedFilterConfig()
    denoise: DenoiseConfig = DenoiseConfig()


def replace(cfg, **kwargs):
    """Convenience: dataclasses.replace re-export."""
    return dataclasses.replace(cfg, **kwargs)
