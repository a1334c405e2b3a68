"""Band-pipelined multi-device SGBM: DP carries streamed between devices.

SGBM's vertical/diagonal path recurrences couple every row to every other,
so sharding ONE frame across devices serializes. The mesh answer (SURVEY.md §5:
"scans with carry exchange between tile neighbors") is a SYSTOLIC
PIPELINE over a microbatch of frames: the image rows are split into one
band per device; a frame's up-sweep flows device n-1 -> 0 and its
down-sweep 0 -> n-1, one band per macro-step, with the (ndir, W, D) Lr
carry `ppermute`d to the neighbor each step. With B frames in flight every
device works on a different frame at each step, so utilization is
B / (B + n - 1) per sweep — classic pipeline-parallel scheduling applied to
a stencil recurrence instead of network layers.

Exactness: identical math to ops.sgbm.sgbm_disparity_banded (band costs
recomputed from 3-row-overlapped image strips; E/W scans and the
selection stage are row-local) — like the banded driver, band-local fp32
cost sums can differ from monolithic by 1 ulp and flip a near-exact
argmin tie on isolated pixels. Verified against the single-chip result in
tests/test_sgbm_pipeline_mesh.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from ..config import SGBMConfig
from ..ops.sgbm import (
    _block_sum,
    _col_scans_ew,
    _pixel_cost,
    _row_scan_dirs,
    _select_from_aggregated,
)

try:  # jax >= 0.8
    from jax import shard_map
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

__all__ = ["sgbm_pipeline_mesh"]


def sgbm_pipeline_mesh(
    mesh: Mesh,
    cfg: SGBMConfig = SGBMConfig(),
    axis: str = "tile",
):
    """Build a jitted pipelined SGBM over the mesh's `axis` (n devices).

    Returns fn(left, right) with (B, H, W) float32 gray batches, H
    divisible by n; rows are sharded over `axis` (each device holds its
    band of every frame) and outputs are returned with the same sharding.
    """
    n = mesh.shape[axis]
    p1, p2 = cfg.resolved_p1p2()
    p1, p2 = float(p1), float(p2)
    if cfg.num_paths not in (4, 5, 8):  # match aggregate_8path's contract
        raise ValueError(f"num_paths must be 4, 5 or 8, got {cfg.num_paths}")
    ndir = 3 if cfg.num_paths in (8, 5) else 1
    use_up = cfg.num_paths != 5  # MODE_SGBM (5) has no upward paths
    nd = cfg.num_disp
    ctx = 3  # sobel (1) + block radius (2)

    def body(lb, rb, lb_up, rb_dn):
        """lb/rb: (B, Hb, W) local band of each frame; lb_up/rb_dn: the
        ctx rows of image context from the neighbors (precomputed outside
        via sharded slicing): *_up = ctx rows ABOVE the band, *_dn = ctx
        rows BELOW (zeros at global edges, replaced by edge replication)."""
        k = lax.axis_index(axis)
        b, hb, w_full = lb.shape
        margin = min(cfg.min_disp + nd, w_full)
        w = w_full - margin

        lbu, lbd = lb_up
        rbu, rbd = rb_dn

        def band_cost(f):
            """Cost volume for MY band of frame f, with edge-cost clamping
            matching the monolithic block sum."""
            fl = jnp.concatenate(
                [lbu[f], jax.lax.dynamic_index_in_dim(lb, f, 0, False), lbd[f]],
                axis=0,
            )
            fr = jnp.concatenate(
                [rbu[f], jax.lax.dynamic_index_in_dim(rb, f, 0, False), rbd[f]],
                axis=0,
            )
            cpix = _pixel_cost(fl, fr, cfg)
            # clamp context rows outside the global image to the edge row's
            # pixel cost (global row index = k*hb - ctx + i)
            g = k * hb - ctx + jnp.arange(hb + 2 * ctx)
            src = jnp.clip(g, 0, n * hb - 1) - (k * hb - ctx)
            cpix = cpix[jnp.clip(src, 0, hb + 2 * ctx - 1)]
            c = _block_sum(cpix, cfg.block_size)
            if cfg.cost_dtype != "float32":
                c = c.astype(cfg.cost_dtype)
            return c[ctx : ctx + hb, margin:]

        dtype = jnp.float32 if cfg.cost_dtype == "float32" else jnp.dtype(cfg.cost_dtype)
        zero_carry = jnp.zeros((ndir, w, nd), dtype) + 0 * lb[0, 0, 0].astype(dtype)

        perm_up = [(i + 1, i) for i in range(n - 1)]
        perm_dn = [(i, i + 1) for i in range(n - 1)]

        # ---------- phase U: record up-carry entering each band (skipped
        # entirely for the 5-path MODE_SGBM direction set) ----------
        up_buf0 = jnp.zeros((b, ndir, w, nd), dtype) + 0 * zero_carry[0, 0, 0]
        if use_up:
            def step_u(state, t):
                carry_in, up_buf = state
                f = t - (n - 1 - k)
                active = (f >= 0) & (f < b)
                fc = jnp.clip(f, 0, b - 1)
                c_b = band_cost(fc)
                carry_use = jnp.where(active, carry_in, zero_carry)
                _, out_carry = _row_scan_dirs(
                    c_b, carry_use, p1, p2, ndir, reverse=True
                )
                up_buf = up_buf.at[fc].set(
                    jnp.where(active, carry_use, up_buf[fc])
                )
                nxt = lax.ppermute(
                    jnp.where(active, out_carry, zero_carry), axis, perm_up
                )
                return (nxt, up_buf), None

            (_, up_buf), _ = lax.scan(
                step_u, (zero_carry, up_buf0), jnp.arange(b + n - 1)
            )
        else:
            up_buf = up_buf0

        # ---------- phase D: finish bands, reduce to disparity ----------
        def step_d(state, t):
            carry_in, disp_out, valid_out = state
            f = t - k
            active = (f >= 0) & (f < b)
            fc = jnp.clip(f, 0, b - 1)
            c_b = band_cost(fc)
            carry_use = jnp.where(active, carry_in, zero_carry)
            s, out_carry = _row_scan_dirs(c_b, carry_use, p1, p2, ndir)
            if use_up:
                up_ys, _ = _row_scan_dirs(
                    c_b, up_buf[fc], p1, p2, ndir, reverse=True
                )
                s = s + up_ys
            s = s + _col_scans_ew(c_b, p1, p2)
            d_b, v_b, _ = _select_from_aggregated(s, cfg, margin, w_full)
            disp_out = disp_out.at[fc].set(jnp.where(active, d_b, disp_out[fc]))
            valid_out = valid_out.at[fc].set(
                jnp.where(active, v_b, valid_out[fc])
            )
            nxt = lax.ppermute(
                jnp.where(active, out_carry, zero_carry), axis, perm_dn
            )
            return (nxt, disp_out, valid_out), None

        disp0 = jnp.zeros((b, hb, w_full), jnp.float32) + 0 * lb[0, 0, 0]
        valid0 = (jnp.zeros((b, hb, w_full), jnp.float32) + 0 * lb[0, 0, 0]) > 1.0
        (_, disp, valid), _ = lax.scan(
            step_d, (zero_carry, disp0, valid0), jnp.arange(b + n - 1)
        )
        return disp, valid

    # context rows from neighbors: computed OUTSIDE shard_map by slicing the
    # globally-sharded batch (XLA turns these into neighbor transfers)
    def fn(left, right):
        bsz, h, w_full = left.shape
        hb = h // n

        # build per-band context via global slicing with edge clamp
        ys = jnp.arange(h).reshape(n, hb)
        up_idx = jnp.clip(ys[:, :1] - jnp.arange(ctx, 0, -1)[None, :], 0, h - 1)
        dn_idx = jnp.clip(ys[:, -1:] + jnp.arange(1, ctx + 1)[None, :], 0, h - 1)

        def gather_ctx(img):
            # (B, n, ctx, W) -> provided to each device as (B, ctx, W)
            u = img[:, up_idx.reshape(-1), :].reshape(bsz, n, ctx, w_full)
            d = img[:, dn_idx.reshape(-1), :].reshape(bsz, n, ctx, w_full)
            return u, d

        lu, ld = gather_ctx(left)
        ru, rd = gather_ctx(right)
        # move the band axis to the sharded position: (n, B, ctx, W)
        lu, ld, ru, rd = (jnp.moveaxis(x, 1, 0) for x in (lu, ld, ru, rd))

        sharded = shard_map(
            lambda lb, rb, lub, ldb, rub, rdb: body(
                lb, rb, (lub[0], ldb[0]), (rub[0], rdb[0])
            ),
            mesh=mesh,
            in_specs=(
                P(None, axis), P(None, axis),
                P(axis), P(axis), P(axis), P(axis),
            ),
            out_specs=(P(None, axis), P(None, axis)),
        )
        return sharded(left, right, lu, ld, ru, rd)

    return jax.jit(fn)
