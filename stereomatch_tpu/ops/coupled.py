"""Coupled PatchMatch <-> variational data-step kernels (Family E live set).

Data-parallel assembly of the reference's hybrid data-step machinery that was
left disconnected in round 1:

  - `hybrid_plane_cost` — evaluateCost_huber's LIVE branch
    (src/PatchMatchStereoGPU.cu:3033-3271): an adaptive-weight window
    (subsampled stride 5, :3126-3128) whose per-tap data term is a
    cost-VOLUME lookup linearly interpolated in d (:3189-3203, clamped to
    0.5) rather than a photometric difference — i.e. PatchMatch planes
    scored against an mc-cnn (or any) matching volume. Weights
    exp(-L1_bgr/5) with colors in [0,255] (:3047,:3150 — weight_c_pmsh =
    255/5 on [0,1] textures); out-of-range taps add cost 1.0 with weight
    0.7 (:3253-3254). The census term is compiled out in the reference
    (#if 0, :3161) and omitted here.
  - `coupled_plane_cost` — the above plus the variational coupling
    0.5*(theta_d*(d/Dmax - v)^2 + theta_n*||n - vn||^2)
    (stereoMatching_huber, :3328-3330): the PatchMatch data step of the
    alternating scheme, pulling plane proposals toward the smoothed
    fields.
  - `huber_rof_field_step` — ONE dual+primal step of the Huber-ROF
    smoothing of the (d, nx, ny) fields (UpdateDualVariablesKernel
    :3903-3982, UpdatePrimalVariablesKernel :3986-4056, host wrapper
    huberROFSmooth :4059-4073): per-pixel edge weight gp, Huber eps=0.001,
    steps 1/sqrt(8), primal extrapolation 2x_new - x_old.

The alternating driver lives in models/coupled.py. The reference's own
alternating loop is dead code (goto FREE_RESOURCE at .cu:7328); this is
the live equivalent SURVEY §2.3 Family E calls for.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import CoupledConfig
from .patchmatch import PlaneState, _nz
from .variational import _div_bwd, _grad_fwd

__all__ = [
    "hybrid_plane_cost",
    "coupled_plane_cost",
    "HuberFields",
    "huber_rof_field_step",
]


def hybrid_plane_cost(
    base_bgr: jax.Array,  # (H, W, 3) in [0, 255]
    base_vol: jax.Array,  # (H, W, D) matching cost, lower = better
    planes: PlaneState,
    cfg: CoupledConfig,
    sign: int,  # -1 left base (match at x - d), +1 right base
) -> jax.Array:
    """Window cost of a plane map against a cost volume (see module doc).

    Per tap (dy, dx) on the subsampled grid: d_tap from the plane; valid iff
    d_tap in [0, max_disp], the matched column is in range, and the tap
    pixel is inside the image; then
        cost += exp(-L1_bgr(center, tap)/gamma) * min(lerp_d(vol[tap]), 0.5)
    else cost += 1.0 with weight 0.7. Returns cost / weight_sum, (H, W).

    Deviation (documented): the reference's lerp assumes mc-cnn's 1-based
    disparity slices ("range [1, max_disp]", .cu:3189-3203); this framework
    indexes slice k = disparity k throughout, so the lerp is between
    floor(d) and floor(d)+1.
    """
    h, w = base_vol.shape[:2]
    nd = base_vol.shape[2]
    r = cfg.window_size // 2
    taps = [
        (dy, dx)
        for dy in range(-r, r + 1, cfg.tap_stride)
        for dx in range(-r, r + 1, cfg.tap_stride)
    ]

    nx, ny, d = planes
    nz = _nz(nx, ny)
    af = -nx / nz
    bf = -ny / nz
    xs = jnp.arange(w, dtype=jnp.float32)[None, :]
    ys = jnp.arange(h, dtype=jnp.float32)[:, None]
    cf = (nx * xs + ny * ys + nz * d) / nz

    pad_spec = ((r, r), (r, r))
    bgr_p = jnp.pad(base_bgr, pad_spec + ((0, 0),), mode="edge")
    vol_p = jnp.pad(base_vol, pad_spec + ((0, 0),), mode="edge")
    offs = jnp.asarray(taps, jnp.int32)

    def tap_step(carry, off):
        cost_acc, w_acc = carry
        dy, dx = off[0], off[1]
        tap_bgr = jax.lax.dynamic_slice(bgr_p, (dy + r, dx + r, 0), (h, w, 3))
        tap_vol = jax.lax.dynamic_slice(vol_p, (dy + r, dx + r, 0), (h, w, nd))
        d_tap = af * (xs + dx) + bf * (ys + dy) + cf
        ok = (
            (d_tap >= 0.0)
            & (d_tap <= cfg.max_disp)
            & (xs + sign * d_tap >= 0)
            & (xs + sign * d_tap < w)
            & (xs + dx >= 0)
            & (xs + dx < w)
            & (ys + dy >= 0)
            & (ys + dy < h)
        )
        weight = jnp.exp(
            -jnp.sum(jnp.abs(base_bgr - tap_bgr), axis=-1) / cfg.gamma_pmsh
        )
        lo = jnp.clip(jnp.floor(d_tap).astype(jnp.int32), 0, nd - 1)
        hi = jnp.clip(lo + 1, 0, nd - 1)
        frac = jnp.clip(d_tap - lo.astype(jnp.float32), 0.0, 1.0)
        c_lo = jnp.take_along_axis(tap_vol, lo[..., None], axis=-1)[..., 0]
        c_hi = jnp.take_along_axis(tap_vol, hi[..., None], axis=-1)[..., 0]
        data = jnp.minimum((1.0 - frac) * c_lo + frac * c_hi, cfg.clamp)
        cost_acc = cost_acc + jnp.where(ok, weight * data, cfg.oob_cost)
        w_acc = w_acc + jnp.where(ok, weight, cfg.oob_weight)
        return (cost_acc, w_acc), None

    init = (jnp.zeros((h, w)), jnp.zeros((h, w)))
    (cost, wsum), _ = jax.lax.scan(tap_step, init, offs)
    return cost / wsum


def coupled_plane_cost(
    base_bgr, base_vol, planes: PlaneState, fields, cfg: CoupledConfig,
    sign: int, theta_d: float | jax.Array, theta_n: float | jax.Array,
) -> jax.Array:
    """lambda * hybrid cost + 0.5*(theta_d*(d/Dmax - v)^2 + theta_n*||n-vn||^2)
    (stereoMatching_huber, .cu:3323-3330)."""
    vd, vnx, vny = fields.vd, fields.vnx, fields.vny
    c = cfg.lambda_data * hybrid_plane_cost(base_bgr, base_vol, planes, cfg, sign)
    dn = planes.d / float(cfg.max_disp)
    return c + 0.5 * (
        theta_d * (dn - vd) ** 2
        + theta_n * ((planes.nx - vnx) ** 2 + (planes.ny - vny) ** 2)
    )


class HuberFields(NamedTuple):
    """Smoothed fields + their dual variables (persist across outer rounds,
    like the reference's device buffers)."""

    vd: jax.Array  # (H, W) smoothed disparity in [0, 1]
    vnx: jax.Array  # smoothed normal x
    vny: jax.Array
    pd: jax.Array  # (H, W, 2) disparity dual
    pn: jax.Array  # (H, W, 4) normal dual (x/y dirs of nx, then of ny)


def init_fields(d_norm: jax.Array, nx: jax.Array, ny: jax.Array) -> HuberFields:
    z2 = jnp.zeros(d_norm.shape + (2,), jnp.float32)
    z4 = jnp.zeros(d_norm.shape + (4,), jnp.float32)
    return HuberFields(d_norm, nx, ny, z2, z4)


def huber_rof_field_step(
    st: HuberFields,
    d_data: jax.Array,  # (H, W) data disparity in [0, 1]
    nx_data: jax.Array,
    ny_data: jax.Array,
    weight: jax.Array,  # per-pixel edge weight gp
    theta_d: float | jax.Array,
    theta_n: float | jax.Array,
    eps: float = 0.001,
    step: float = float(1.0 / np.sqrt(8.0)),  # np: a jnp default would run on-device at IMPORT
) -> HuberFields:
    """One dual+primal Huber-ROF step on (vd, vnx, vny) toward the data
    fields (kernels .cu:3903-4056; constants: eps .cu:3938, steps
    1/sqrt(8) .cu:3940-3941/4046-4047, extrapolation .cu:4053-4056)."""
    gp = weight
    gp_inv = 1.0 / gp

    def dual_pair(p2, f):
        dx, dy = _grad_fwd(f)
        t0 = (p2[..., 0] + step * gp * dx) / (1.0 + step * eps * gp_inv)
        t1 = (p2[..., 1] + step * gp * dy) / (1.0 + step * eps * gp_inv)
        norm = jnp.maximum(1.0, jnp.sqrt(t0 * t0 + t1 * t1))
        return jnp.stack([t0 / norm, t1 / norm], axis=-1)

    pd = dual_pair(st.pd, st.vd)
    pn_x = dual_pair(st.pn[..., 0:2], st.vnx)
    pn_y = dual_pair(st.pn[..., 2:4], st.vny)
    pn = jnp.concatenate([pn_x, pn_y], axis=-1)

    def primal(v, p2, data, theta):
        div = _div_bwd(p2[..., 0], p2[..., 1])
        v_t = (v + step * (theta * data + gp * div)) / (1.0 + step * theta)
        return 2.0 * v_t - v  # extrapolation (.cu:4053-4056)

    vd = primal(st.vd, pd, d_data, theta_d)
    vnx = primal(st.vnx, pn[..., 0:2], nx_data, theta_n)
    vny = primal(st.vny, pn[..., 2:4], ny_data, theta_n)
    return HuberFields(vd, vnx, vny, pd, pn)
