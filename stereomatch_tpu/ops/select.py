"""Disparity selection: WTA with parabola subpixel refinement.

Data-parallel replacement for the reference's selectDisparity kernel
(src/PatchMatchStereoGPU.cu:1688-1737): per-pixel argmin over the disparity
axis (strict '<' so the first minimum wins ties), then a one-shot parabola
fit through (pre, cur, next) costs. At the volume's d-boundaries the missing
neighbor cost is taken as 0.0, exactly as the reference does (.cu:1722-1725),
and the subpixel update is applied only when |update| < 1 (.cu:1731); the
update is SUBTRACTED ("minus if disparity", .cu:1732).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["wta_disparity", "wta_argmin", "wta_coupled"]


def wta_argmin(volume: jax.Array) -> jax.Array:
    """Plain argmin over the last (disparity) axis, first-minimum ties."""
    return jnp.argmin(volume, axis=-1)


def wta_coupled(
    volume: jax.Array,
    u: jax.Array,
    lagr: jax.Array,
    lambda_d: float,
    theta_inv: float,
    min_disp: int = 0,
    subpixel: bool = True,
) -> jax.Array:
    """WTA over the augmented-Lagrangian-coupled cost
        lambda_d * C(d) + L * (u - d) + (u - d)^2 / (2 theta)
    (ref: MCCNN_ALTV_CostVolumeWTA, src/PatchMatchStereoGPU.cu:4748-4803) —
    the data step of the AL-TGV splitting: pick the disparity that balances
    matching cost against staying close to the smoothed field u.
    """
    nd = volume.shape[-1]
    ds = jnp.arange(nd, dtype=jnp.float32) + float(min_disp)
    diff = u[..., None] - ds
    coupled = lambda_d * volume + lagr[..., None] * diff + 0.5 * theta_inv * diff * diff
    return wta_disparity(coupled, min_disp, subpixel)


def wta_disparity(
    volume: jax.Array, min_disp: int = 0, subpixel: bool = True
) -> jax.Array:
    """WTA disparity (float32) from an (H, W, D) cost volume.

    Returns best_d + min_disp - parabola_update, with the reference's
    boundary convention (out-of-volume neighbor cost = 0.0) and |update|<1
    acceptance gate. Division by a zero curvature yields inf/nan which the
    gate rejects, matching the reference's unguarded float math.
    """
    num_disp = volume.shape[-1]
    best = jnp.argmin(volume, axis=-1)
    disp = (best + min_disp).astype(jnp.float32)
    if not subpixel:
        return disp

    cur = jnp.take_along_axis(volume, best[..., None], axis=-1)[..., 0]
    pre_idx = jnp.maximum(best - 1, 0)
    next_idx = jnp.minimum(best + 1, num_disp - 1)
    pre = jnp.take_along_axis(volume, pre_idx[..., None], axis=-1)[..., 0]
    nxt = jnp.take_along_axis(volume, next_idx[..., None], axis=-1)[..., 0]
    pre = jnp.where(best == 0, 0.0, pre)
    nxt = jnp.where(best == num_disp - 1, 0.0, nxt)

    update = (nxt - pre) * 0.5 / (nxt - 2.0 * cur + pre)
    return jnp.where(jnp.abs(update) < 1.0, disp - update, disp)
