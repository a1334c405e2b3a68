"""Halo exchange for row-tiled images (the image analog of context/ring
parallelism — SURVEY.md §5 maps the reference's shared-memory row tiling,
src/PatchMatchStereoGPU.cu:1302-1346, onto device collectives)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

__all__ = ["halo_exchange_rows"]


def halo_exchange_rows(x: jax.Array, halo: int, axis_name: str) -> jax.Array:
    """Inside shard_map: extend a row-sharded block (Hs, ...) with `halo`
    rows from each neighbor along `axis_name` (edge blocks get zero rows —
    callers that need edge replication can re-pad afterwards).

    Uses two `ppermute`s (up and down neighbors), the standard pattern
    for stencil halos on a device mesh.
    """
    n = lax.axis_size(axis_name)
    if halo == 0 or n == 1:
        pad = [(halo, halo)] + [(0, 0)] * (x.ndim - 1)
        return jnp.pad(x, pad)
    top = x[:halo]  # my first rows -> previous tile's bottom halo
    bot = x[-halo:]  # my last rows -> next tile's top halo
    # receive from previous tile (its bottom rows become my top halo)
    from_prev = lax.ppermute(bot, axis_name, [(i, i + 1) for i in range(n - 1)])
    # receive from next tile (its top rows become my bottom halo)
    from_next = lax.ppermute(top, axis_name, [(i + 1, i) for i in range(n - 1)])
    return jnp.concatenate([from_prev, x, from_next], axis=0)
