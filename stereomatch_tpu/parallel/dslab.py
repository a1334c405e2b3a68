"""Disparity-slab (dslab) sharding: WTA as one argmin-combine collective.

SURVEY.md §5 maps the reference's disparity-slice parallelism (OMP slice
loop src/PatchMatchStereoGPU.cu:8733-8769, stream pairs :8584-8617, 3-D
grids :8968) onto a sharded D axis: every volume op before disparity
selection is slice-local (cost build, guided filter), so the ONLY
cross-shard communication of the whole aggregation stage is the final
WTA — a pmin/psum argmin-combine tree over the "dslab" mesh axis, plus a
one-slice halo exchange so the parabola subpixel fit sees its d±1
neighbors across shard boundaries.

Semantics match ops.select.wta_disparity exactly (first-minimum ties =
smallest global d; out-of-volume neighbor cost 0.0; |update| < 1 gate).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

__all__ = ["wta_disparity_dslab"]

# np scalar, NOT jnp: a module-level jax array would initialize the
# backend at import time; np.float32 has identical dtype semantics
_BIG = np.float32(3e38)


def wta_disparity_dslab(
    vol: jax.Array,
    min_disp: int,
    axis_name: str,
    subpixel: bool = True,
) -> jax.Array:
    """WTA disparity from a D-sharded cost volume, inside shard_map.

    vol: (H, W, Ds) — this shard's contiguous d-slices; shard k covers
    global d in [k*Ds, (k+1)*Ds). Returns (H, W) float32 disparity,
    replicated along `axis_name` (the collective result is identical on
    every shard). Matches ops.select.wta_disparity bit-for-bit on equal
    inputs (ties break to the smallest global d, like argmin).
    """
    n = lax.axis_size(axis_name)
    idx = lax.axis_index(axis_name)
    ds = vol.shape[-1]
    d0 = idx * ds
    nd_total = n * ds

    # local argmin (first minimum wins ties within the shard)
    best = jnp.argmin(vol, axis=-1)
    m = jnp.min(vol, axis=-1)
    gbest = best + d0

    # global min + smallest-d tie-break
    gmin = lax.pmin(m, axis_name)
    winner = m == gmin
    gd = lax.pmin(jnp.where(winner, gbest, nd_total), axis_name)
    mask = winner & (gbest == gd)  # exactly one shard: d-ranges are disjoint

    disp = (gd + min_disp).astype(jnp.float32)
    if not subpixel:
        return disp

    # d±1 neighbor costs: one boundary slice from each dslab neighbor
    # (ppermute zero-fills at the global ends — exactly the reference's
    # out-of-volume neighbor cost 0.0, .cu:1722-1725)
    from_prev = lax.ppermute(
        vol[..., -1], axis_name, [(i, i + 1) for i in range(n - 1)]
    )
    from_next = lax.ppermute(
        vol[..., 0], axis_name, [(i + 1, i) for i in range(n - 1)]
    )
    ids = jnp.arange(ds)[None, None, :]
    b3 = best[..., None]
    pre_in = jnp.min(jnp.where(ids == b3 - 1, vol, _BIG), axis=-1)
    nxt_in = jnp.min(jnp.where(ids == b3 + 1, vol, _BIG), axis=-1)
    pre = jnp.where(best == 0, from_prev, pre_in)
    nxt = jnp.where(best == ds - 1, from_next, nxt_in)

    sel = lambda v: lax.psum(jnp.where(mask, v, 0.0), axis_name)  # noqa: E731
    cur = gmin
    pre_g, nxt_g = sel(pre), sel(nxt)

    update = (nxt_g - pre_g) * 0.5 / (nxt_g - 2.0 * cur + pre_g)
    return jnp.where(jnp.abs(update) < 1.0, disp - update, disp)
