"""Separable box filters, guided filter, and small median filters.

Data-parallel replacements for the reference's CUDA "Family A" kernels
(src/PatchMatchStereoGPU.cu:228-860) and "Family D" guided-filter stack
(:7945-8772). The sliding-window/texture/shared-memory machinery collapses
into cumsum-based integral sums that XLA fuses; the whole-volume filter
streams disparity slabs through a `lax.scan` (replacing per-slice CUDA
streams / pthread fan-out, .cu:8539-8619) to bound HBM residency.

Border semantics of the reference box filters (boxFilter_x_global,
.cu:528-551): zero padding with a FIXED 1/(2r+1) normalization (windows
shrink toward zero at borders). `mode="zero"` reproduces that;
`mode="count"` normalizes by the number of in-bounds taps; `mode="reflect"`
matches cv2.blur's BORDER_REFLECT_101.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

__all__ = [
    "box_filter_sum",
    "box_filter",
    "guided_filter_gray",
    "guided_filter_volume",
    "guided_filter_color",
    "median3x3",
]


def box_filter_sum(x: jax.Array, radius: int, axis: int) -> jax.Array:
    """Windowed sum over a (2*radius+1) window along `axis`, zero padding."""
    if radius == 0:
        return x
    n = x.shape[axis]
    pad = [(0, 0)] * x.ndim
    pad[axis] = (radius + 1, radius)
    xp = jnp.pad(x, pad)
    c = jnp.cumsum(xp, axis=axis)
    hi = jax.lax.slice_in_dim(c, 2 * radius + 1, 2 * radius + 1 + n, axis=axis)
    lo = jax.lax.slice_in_dim(c, 0, n, axis=axis)
    return hi - lo


def _reflect101(x: jax.Array, radius: int, axis: int) -> jax.Array:
    pad = [(0, 0)] * x.ndim
    pad[axis] = (radius, radius)
    return jnp.pad(x, pad, mode="reflect")


def box_filter(
    x: jax.Array,
    radius: int,
    axes: tuple[int, ...] = (0, 1),
    mode: str = "zero",
) -> jax.Array:
    """Separable box *mean* filter along `axes`."""
    if mode == "zero":
        out = x
        for ax in axes:
            out = box_filter_sum(out, radius, ax) * (1.0 / (2 * radius + 1))
        return out
    if mode == "count":
        num = x
        for ax in axes:
            num = box_filter_sum(num, radius, ax)
        # in-bounds tap count: ones of x's rank (size-1 on unfiltered axes,
        # so the same `axes` indices apply), filtered along the same axes
        reshape = [1] * x.ndim
        for a in axes:
            reshape[a] = x.shape[a]
        cnt = jnp.ones(reshape, x.dtype)
        for ax in axes:
            cnt = box_filter_sum(cnt, radius, ax)
        return num / cnt
    if mode == "reflect":
        out = x
        for ax in axes:
            n = out.shape[ax]
            xp = _reflect101(out, radius, ax)
            c = jnp.cumsum(xp, axis=ax)
            zero = jax.lax.slice_in_dim(c, 0, 1, axis=ax) * 0
            c = jnp.concatenate([zero, c], axis=ax)
            hi = jax.lax.slice_in_dim(c, 2 * radius + 1, 2 * radius + 1 + n, axis=ax)
            lo = jax.lax.slice_in_dim(c, 0, n, axis=ax)
            out = (hi - lo) * (1.0 / (2 * radius + 1))
        return out
    raise ValueError(f"unknown box filter mode {mode!r}")


def guided_filter_gray(
    guide: jax.Array,
    src: jax.Array,
    radius: int,
    eps: float,
    mode: str = "zero",
) -> jax.Array:
    """He et al. guided filter with a single-channel guide.

    guide: (H, W); src: (H, W) or (H, W, K) filtered per-channel with shared
    guide statistics (the per-disparity-slice loop of
    costVolumeGuidedFilterCUDA, .cu:7977-8160, vectorized over K).
    Equations match guidedFilterComputation1/2 (.cu:7945-7975):
    a = (corr_gi - mu_g*mu_i) / (var_g + eps); b = mu_i - a*mu_g;
    out = mean(a)*g + mean(b).
    """
    g = guide
    squeeze = src.ndim == 2
    p = src[..., None] if squeeze else src

    mean_g = box_filter(g, radius, (0, 1), mode)
    var_g = box_filter(g * g, radius, (0, 1), mode) - mean_g * mean_g

    mean_p = box_filter(p, radius, (0, 1), mode)
    corr_gp = box_filter(g[..., None] * p, radius, (0, 1), mode)
    a = (corr_gp - mean_g[..., None] * mean_p) / (var_g[..., None] + eps)
    b = mean_p - a * mean_g[..., None]
    out = box_filter(a, radius, (0, 1), mode) * g[..., None] + box_filter(
        b, radius, (0, 1), mode
    )
    return out[..., 0] if squeeze else out


def guided_filter_volume(
    guide: jax.Array,
    volume: jax.Array,
    radius: int,
    eps: float,
    slab: int = 16,
    mode: str = "zero",
) -> jax.Array:
    """Guided-filter an (H, W, D) cost volume, streaming D in slabs of
    `slab` slices so peak memory stays ~2 slabs instead of several full
    volumes. Guide statistics are computed once (the reference also hoists
    mean_guide/var_g out of the slice loop, .cu:9078-9102)."""
    H, W, D = volume.shape
    g = guide
    mean_g = box_filter(g, radius, (0, 1), mode)
    var_g = box_filter(g * g, radius, (0, 1), mode) - mean_g * mean_g
    denom = var_g + eps

    if D % slab != 0:
        pad_d = slab - D % slab
        volume = jnp.pad(volume, ((0, 0), (0, 0), (0, pad_d)))
    else:
        pad_d = 0
    nslabs = volume.shape[2] // slab
    vol_s = jnp.moveaxis(volume.reshape(H, W, nslabs, slab), 2, 0)

    def step(_, p):
        mean_p = box_filter(p, radius, (0, 1), mode)
        corr_gp = box_filter(g[..., None] * p, radius, (0, 1), mode)
        a = (corr_gp - mean_g[..., None] * mean_p) / denom[..., None]
        b = mean_p - a * mean_g[..., None]
        q = box_filter(a, radius, (0, 1), mode) * g[..., None] + box_filter(
            b, radius, (0, 1), mode
        )
        return None, q

    _, out = jax.lax.scan(step, None, vol_s)
    out = jnp.moveaxis(out, 0, 2).reshape(H, W, nslabs * slab)
    return out[:, :, :D] if pad_d else out


def guided_filter_color(
    guide_rgb: jax.Array,
    src: jax.Array,
    radius: int,
    eps: float,
    mode: str = "zero",
) -> jax.Array:
    """Guided filter with an RGB guide: per-pixel 3x3 covariance with
    explicit inverse (ref: colorGuidedFilterHelper0-5 and the d_inv_*/
    d_cov_det globals, .cu:8173-8537, :112-139).

    guide_rgb: (H, W, 3); src: (H, W) or (H, W, K).
    """
    squeeze = src.ndim == 2
    p = src[..., None] if squeeze else src
    g = guide_rgb

    mean_g = box_filter(g, radius, (0, 1), mode)  # (H, W, 3)

    # 3x3 covariance of the guide (symmetric, 6 unique terms)
    def cov(i, j):
        return (
            box_filter(g[..., i] * g[..., j], radius, (0, 1), mode)
            - mean_g[..., i] * mean_g[..., j]
            + (eps if i == j else 0.0)
        )

    c00, c01, c02 = cov(0, 0), cov(0, 1), cov(0, 2)
    c11, c12, c22 = cov(1, 1), cov(1, 2), cov(2, 2)

    # explicit inverse via adjugate
    i00 = c11 * c22 - c12 * c12
    i01 = c02 * c12 - c01 * c22
    i02 = c01 * c12 - c02 * c11
    i11 = c00 * c22 - c02 * c02
    i12 = c01 * c02 - c00 * c12
    i22 = c00 * c11 - c01 * c01
    det = c00 * i00 + c01 * i01 + c02 * i02
    inv_det = 1.0 / det

    mean_p = box_filter(p, radius, (0, 1), mode)  # (H, W, K)
    cov_gp = [
        box_filter(g[..., i : i + 1] * p, radius, (0, 1), mode)
        - mean_g[..., i : i + 1] * mean_p
        for i in range(3)
    ]

    a0 = (i00[..., None] * cov_gp[0] + i01[..., None] * cov_gp[1] + i02[..., None] * cov_gp[2]) * inv_det[..., None]
    a1 = (i01[..., None] * cov_gp[0] + i11[..., None] * cov_gp[1] + i12[..., None] * cov_gp[2]) * inv_det[..., None]
    a2 = (i02[..., None] * cov_gp[0] + i12[..., None] * cov_gp[1] + i22[..., None] * cov_gp[2]) * inv_det[..., None]
    b = (
        mean_p
        - a0 * mean_g[..., 0:1]
        - a1 * mean_g[..., 1:2]
        - a2 * mean_g[..., 2:3]
    )

    out = (
        box_filter(a0, radius, (0, 1), mode) * g[..., 0:1]
        + box_filter(a1, radius, (0, 1), mode) * g[..., 1:2]
        + box_filter(a2, radius, (0, 1), mode) * g[..., 2:3]
        + box_filter(b, radius, (0, 1), mode)
    )
    return out[..., 0] if squeeze else out


def median3x3(x: jax.Array) -> jax.Array:
    """3x3 median filter with replicated borders (cv::medianBlur ksize=3
    equivalent — the 3DMST segmentation prefilter, Stereo3DMST.cpp:226-228).
    Implemented as a 9-element sorting network over shifted copies — pure
    VPU work, no data-dependent control flow."""
    xp = jnp.pad(x, ((1, 1), (1, 1)) + ((0, 0),) * (x.ndim - 2), mode="edge")
    H, W = x.shape[0], x.shape[1]
    taps = [
        xp[dy : dy + H, dx : dx + W] for dy in range(3) for dx in range(3)
    ]

    def cas(i, j):
        lo = jnp.minimum(taps[i], taps[j])
        hi = jnp.maximum(taps[i], taps[j])
        taps[i], taps[j] = lo, hi

    # optimal 9-element median network (19 compare-exchanges)
    for i, j in [
        (0, 1), (3, 4), (6, 7), (1, 2), (4, 5), (7, 8), (0, 1), (3, 4),
        (6, 7), (0, 3), (3, 6), (1, 4), (4, 7), (2, 5), (5, 8), (1, 3),
        (5, 7), (2, 6), (4, 6), (2, 4), (2, 3), (4, 5),
    ]:
        cas(i, j)
    return taps[4]
