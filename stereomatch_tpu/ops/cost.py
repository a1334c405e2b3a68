"""Matching-cost construction: census, AD+gradient BGR, ZNCC/AD/AGD volumes.

Data-parallel replacements for the reference's "Family B" CUDA kernels and CPU
census (ref: src/StereoMatching.cpp:27-114, src/PatchMatchStereoGPU.cu:1294-1632).
The per-row shared-memory staging of the CUDA kernels collapses into whole-
image shifted-stack arithmetic that XLA fuses; the census Hamming cost is
computed by packing ternary codes into two uint32 bitplanes and using
XOR/OR + population_count (≈15 vector ops per 32 window taps instead of 32
scalar compares).

Cost-volume conventions (disparity-last so D rides the 128-wide lane dim):
  right volume: rvol[y, x, d] = cost(right(y, x), left(y, x + d))
  left  volume: lvol[y, x, d] = cost(left(y, x),  right(y, x - d))
The reference computes the right-reference cost once and mirrors it into the
left volume at column x+d (PatchMatchStereoGPU.cu:1405-1406, :1541-1543);
here both volumes come from the same shifted-stack expression, which is the
same arithmetic without the scatter.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import CensusConfig, CostVolumeConfig, ZNCCConfig
from .filters import box_filter

__all__ = [
    "shifted_stack",
    "local_contrast",
    "bgr_to_gray",
    "ternary_census_planes",
    "census_cost_volumes",
    "census_stereo",
    "adgrad_bgr_volumes",
    "windowed_volumes",
]


def shifted_stack(img: jax.Array, num_disp: int, sign: int, min_disp: int = 0):
    """Stack of horizontally shifted copies: out[y, x, k] = img[y, x + sign*(min_disp+k)].

    Returns (stack, valid) where valid[x, k] marks in-bounds source columns
    (out-of-bounds entries hold the edge-clamped value, as the previous
    gather formulation did). img may be (H, W) or (H, W, C); the disparity
    axis is inserted after W.

    Implemented as NUM_DISP static slices of an edge-padded image rather
    than one big gather — XLA lowers slices to cheap copies.
    """
    w = img.shape[1]
    lo = min(sign * min_disp, sign * (min_disp + num_disp - 1), 0)
    hi = max(sign * min_disp, sign * (min_disp + num_disp - 1), 0)
    pad = [(0, 0)] * img.ndim
    pad[1] = (-lo, hi)
    imgp = jnp.pad(img, pad, mode="edge")
    slices = [
        jax.lax.slice_in_dim(imgp, sign * (min_disp + k) - lo, sign * (min_disp + k) - lo + w, axis=1)
        for k in range(num_disp)
    ]
    stack = jnp.stack(slices, axis=2)
    idx = jnp.arange(w)[:, None] + sign * (min_disp + jnp.arange(num_disp))[None, :]
    valid = (idx >= 0) & (idx < w)
    return stack, valid


def local_contrast(img: jax.Array, radius: int) -> jax.Array:
    """Subtract the local box mean (ref: the zero-mean pre-pass of the cost
    pipeline, src/PatchMatchStereoGPU.cu:8936-8961)."""
    return img - box_filter(img, radius, (0, 1), mode="zero")


def bgr_to_gray(bgr: jax.Array) -> jax.Array:
    """BT.601 gray from BGR channel order, matching the reference's weights
    (src/PatchMatchStereoGPU.cu:1531-1537: 0.114*B + 0.587*G + 0.299*R)."""
    return 0.114 * bgr[..., 0] + 0.587 * bgr[..., 1] + 0.299 * bgr[..., 2]


# ---------------------------------------------------------------------------
# Ternary census
# ---------------------------------------------------------------------------


def _census_offsets(win_rw: int, win_rh: int):
    return [
        (dy, dx)
        for dy in range(-win_rh, win_rh + 1)
        for dx in range(-win_rw, win_rw + 1)
        if not (dy == 0 and dx == 0)
    ]


def ternary_census_planes(
    img: jax.Array, win_rw: int = 4, win_rh: int = 8, epsilon: float = 0.0045
):
    """Ternary census transform packed into two uint32 bitplanes.

    For each window offset o: code is +1 / 0 / -1 as I(p+o) - I(p) compares
    against ±epsilon (ref: src/StereoMatching.cpp:76-93, on intensities
    normalized to [0, 1]). Bitplane `pos` packs (code == +1), `neg` packs
    (code == -1); two codes differ iff (pos_a ^ pos_b) | (neg_a ^ neg_b) has
    the tap's bit set, so Hamming distance = popcount of that word.

    Note: the reference CPU census centers the *left* window's comparisons on
    left[x] rather than on the matched center left[x+d]
    (src/StereoMatching.cpp:76 uses p_left[x] for every d). That makes the
    "transform" disparity-dependent and is a defect in the reference; this
    implementation uses the standard census (each window centered on its own
    pixel), which is the intended algorithm.

    Returns (pos, neg): each (H, W, n_words) uint32, where
    n_words = ceil(n_offsets / 32). Border taps use edge padding.
    """
    offsets = _census_offsets(win_rw, win_rh)
    h, w = img.shape[:2]
    padded = jnp.pad(img, ((win_rh, win_rh), (win_rw, win_rw)), mode="edge")
    center = img

    n_words = (len(offsets) + 31) // 32
    pos_words = [jnp.zeros((h, w), jnp.uint32) for _ in range(n_words)]
    neg_words = [jnp.zeros((h, w), jnp.uint32) for _ in range(n_words)]
    for bit, (dy, dx) in enumerate(offsets):
        tap = jax.lax.dynamic_slice(padded, (dy + win_rh, dx + win_rw), (h, w))
        diff = tap - center
        word, shift = divmod(bit, 32)
        one = jnp.uint32(1 << shift)
        pos_words[word] = pos_words[word] | jnp.where(diff > epsilon, one, jnp.uint32(0))
        neg_words[word] = neg_words[word] | jnp.where(diff < -epsilon, one, jnp.uint32(0))
    return jnp.stack(pos_words, axis=-1), jnp.stack(neg_words, axis=-1)


def census_cost_volumes(
    left: jax.Array, right: jax.Array, cfg: CensusConfig = CensusConfig()
):
    """Ternary-census Hamming cost volumes for both views.

    left/right: (H, W) gray in [0, 1] (the reference normalizes by 1/255,
    src/StereoMatching.cpp:44-47). Returns (lvol, rvol), each (H, W, D) int32
    with D = d_max + 1. Out-of-range disparities get the max cost
    (= number of window taps) so WTA never selects them.
    """
    n_taps = (2 * cfg.win_rw + 1) * (2 * cfg.win_rh + 1) - 1
    pos_l, neg_l = ternary_census_planes(left, cfg.win_rw, cfg.win_rh, cfg.epsilon)
    pos_r, neg_r = ternary_census_planes(right, cfg.win_rw, cfg.win_rh, cfg.epsilon)
    num_disp = cfg.d_max + 1

    def hamming(pos_a, neg_a, pos_b_stack, neg_b_stack, valid):
        diff = (pos_a[:, :, None, :] ^ pos_b_stack) | (neg_a[:, :, None, :] ^ neg_b_stack)
        cost = jnp.sum(
            jax.lax.population_count(diff).astype(jnp.int32), axis=-1
        )
        return jnp.where(valid[None, :, :], cost, n_taps)

    # right reference matches left at x + d; left reference matches right at x - d
    pos_ls, vr = shifted_stack(pos_l, num_disp, +1)
    neg_ls, _ = shifted_stack(neg_l, num_disp, +1)
    rvol = hamming(pos_r, neg_r, pos_ls, neg_ls, vr)

    pos_rs, vl = shifted_stack(pos_r, num_disp, -1)
    neg_rs, _ = shifted_stack(neg_r, num_disp, -1)
    lvol = hamming(pos_l, neg_l, pos_rs, neg_rs, vl)
    return lvol, rvol


def census_stereo(
    left: jax.Array, right: jax.Array, cfg: CensusConfig = CensusConfig()
) -> jax.Array:
    """Right-image integer WTA disparity from the ternary census cost, with
    the reference's valid interior (rows win_rh..H-win_rh-1, cols
    win_rw..W-win_rw-d_max-1; everything else 0 — src/StereoMatching.cpp:52-59,
    output dtype CV_16U i.e. integer WTA with first-minimum ties).
    """
    _, rvol = census_cost_volumes(left, right, cfg)
    disp = jnp.argmin(rvol, axis=-1).astype(jnp.int32)
    h, w = left.shape[:2]
    ys = jnp.arange(h)[:, None]
    xs = jnp.arange(w)[None, :]
    interior = (
        (ys >= cfg.win_rh)
        & (ys < h - cfg.win_rh)
        & (xs >= cfg.win_rw)
        & (xs < w - cfg.win_rw - cfg.d_max)
    )
    return jnp.where(interior, disp, 0)


# ---------------------------------------------------------------------------
# Pixelwise truncated AD + gradient BGR cost (the production volume cost)
# ---------------------------------------------------------------------------


def adgrad_bgr_volumes(
    left_bgr: jax.Array, right_bgr: jax.Array, cfg: CostVolumeConfig = CostVolumeConfig()
):
    """Pixelwise truncated-AD + gray-forward-gradient BGR cost volumes
    (ref: buildCostVolumeSharedMemoryBGR, src/PatchMatchStereoGPU.cu:1482-1550).

    cost = 0.11 * min(L1_bgr / 3, 7) + 0.89 * min(|g_ref - g_match|, 2)
    where g is the forward x-gradient of BT.601 gray. Images are (H, W, 3)
    float in [0, 255]. A right-reference pixel x at disparity d is valid iff
    x + d + 1 < W (the +1 feeds the forward gradient, .cu:1519); invalid
    entries get bad_cost. The left volume is the same cost indexed at the
    left pixel x (valid iff x - d >= 0 and x + 1 < W).

    Returns (lvol, rvol), each (H, W, D) float32.
    """
    num_disp = cfg.num_disp
    w = left_bgr.shape[1]

    def grad_x(gray):
        return jnp.diff(gray, axis=1, append=gray[:, -1:])

    gray_l = bgr_to_gray(left_bgr)
    gray_r = bgr_to_gray(right_bgr)
    gl, gr = grad_x(gray_l), grad_x(gray_r)

    def volume(ref_bgr, ref_grad, match_bgr, match_grad, sign):
        match_stack, _ = shifted_stack(match_bgr, num_disp, sign, cfg.min_disp)
        grad_stack, _ = shifted_stack(match_grad, num_disp, sign, cfg.min_disp)
        color_l1 = jnp.sum(jnp.abs(ref_bgr[:, :, None, :] - match_stack), axis=-1)
        grad_l1 = jnp.abs(ref_grad[:, :, None] - grad_stack)
        return cfg.color_weight * jnp.minimum(
            color_l1 * (1.0 / 3.0), cfg.color_truncation
        ) + cfg.gradient_weight * jnp.minimum(grad_l1, cfg.gradient_truncation)

    xs = jnp.arange(w)[:, None]
    ds = cfg.min_disp + jnp.arange(num_disp)[None, :]

    rvol = volume(right_bgr, gr, left_bgr, gl, +1)
    rvol = jnp.where((xs + ds + 1 < w)[None], rvol, cfg.bad_cost)

    lvol = volume(left_bgr, gl, right_bgr, gr, -1)
    lvol = jnp.where(((xs - ds >= 0) & (xs + 1 < w))[None], lvol, cfg.bad_cost)
    return lvol.astype(jnp.float32), rvol.astype(jnp.float32)


# ---------------------------------------------------------------------------
# Windowed gray costs: ZNCC / truncated AD / AD+gradient
# ---------------------------------------------------------------------------


def windowed_volumes(
    left_gray: jax.Array, right_gray: jax.Array, cfg: ZNCCConfig = ZNCCConfig()
):
    """Windowed gray cost volumes over a (2r+1)^2 box
    (ref: buildCostVolumeSharedMemory, src/PatchMatchStereoGPU.cu:1298-1479).

    metric="zncc": cost = -sum(ref*match) / (N * rms(ref) * rms(match))
      over the window (the reference's un-centered "ZNCC" — the images are
      expected to be locally mean-subtracted beforehand, .cu:8936-8961).
    metric="ad":   sum of min(|ref - match|, 7) over the window.
    metric="agd":  sum of 0.1*min(|ref-match|,7) + 0.9*min(|grad diff|,2)
      (.cu:1386-1390 — note 0.1/0.9 here vs 0.11/0.89 in the BGR kernel).

    Window sums use cumsum box filters instead of the reference's per-thread
    O(r^2) loops. Out-of-range entries get N*bad_cost to mirror the
    reference's sentinel (.cu:1410, :1420). Returns (lvol, rvol) float32.
    """
    r = cfg.win_radius
    n = float((2 * r + 1) ** 2)
    num_disp = cfg.max_disp - cfg.min_disp + 1
    w = left_gray.shape[1]

    def win_sum(x):
        return box_filter(x, r, (0, 1), mode="zero") * n if r else x

    def grad_x(g):
        return jnp.diff(g, axis=1, append=g[:, -1:])

    def volume(ref, match, sign):
        match_stack, _ = shifted_stack(match, num_disp, sign, cfg.min_disp)
        if cfg.metric == "zncc":
            prod = win_sum(ref[:, :, None] * match_stack)
            ref_ss = win_sum(ref * ref)[:, :, None]
            match_ss = win_sum(match_stack * match_stack)
            denom = n * jnp.sqrt(ref_ss / n) * jnp.sqrt(match_ss / n)
            return -prod / jnp.maximum(denom, 1e-20)
        if cfg.metric == "ad":
            return win_sum(
                jnp.minimum(jnp.abs(ref[:, :, None] - match_stack), 7.0)
            )
        if cfg.metric == "agd":
            gref = grad_x(ref)
            gstack, _ = shifted_stack(grad_x(match), num_disp, sign, cfg.min_disp)
            return win_sum(
                0.1 * jnp.minimum(jnp.abs(ref[:, :, None] - match_stack), 7.0)
                + 0.9 * jnp.minimum(jnp.abs(gref[:, :, None] - gstack), 2.0)
            )
        raise ValueError(f"unknown windowed metric {cfg.metric!r}")

    xs = jnp.arange(w)[:, None]
    ds = cfg.min_disp + jnp.arange(num_disp)[None, :]
    sentinel = n * cfg.bad_cost

    rvol = volume(right_gray, left_gray, +1)
    rvol = jnp.where((xs + ds + r + 1 < w)[None], rvol, sentinel)
    lvol = volume(left_gray, right_gray, -1)
    lvol = jnp.where((xs - ds - r >= 0)[None], lvol, sentinel)
    return lvol.astype(jnp.float32), rvol.astype(jnp.float32)
