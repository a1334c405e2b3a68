"""Semi-global matching (SGBM) as vectorized (min,+) scans.

The reference's namesake algorithm is OpenCV's StereoSGBM, configured at
src/StereoMatching.cpp:148-193 (blockSize 5, P1=8*cn*bs^2, P2=32*cn*bs^2,
uniqueness 10, speckle 100/32, disp12MaxDiff 1, MODE_HH full 8-path,
prefilterCap 63) and invoked with numDisparities=16*16 from
src/stereo_opencv.cpp:150. This module re-derives that algorithm as whole-array passes:

  - pixel cost: Birchfield-Tomasi on the x-Sobel-prefiltered image plus a
    quarter-weighted BT on raw intensity (OpenCV's calcPixelCostBT blend),
    summed over the blockSize window with a cumsum box filter;
  - 8-path aggregation: the per-pixel DP recurrence
      Lr(p,d) = C(p,d) + min(Lr(p-r,d), Lr(p-r,d±1)+P1, minLr(p-r)+P2)
                - minLr(p-r)
    becomes FOUR `lax.scan`s: one down-scan carrying the three downward
    directions (S, SE, SW — the diagonals are the same row recurrence with
    the carry shifted one column), one up-scan for N, NE, NW, and two
    column scans for E/W. Each scan step is an (dirs, W, D) fused
    elementwise min — the hot loop is pure VPU work with D on the lane dim;
  - WTA + uniqueness ratio + quadratic subpixel + left/right (disp12)
    invalidation, all vectorized.

Speckle filtering lives in ops/speckle.py (parallel connected components).
Outputs are float32 disparities (the reference converts OpenCV's CV_16S
fixed point back to float /16, src/StereoMatching.cpp:186-189; we never
leave float). Invalid pixels get `INVALID_DISP` = min_disp - 1.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import SGBMConfig

__all__ = [
    "xsobel_clipped",
    "bt_cost_volume",
    "sgbm_cost_volume",
    "aggregate_8path",
    "sgbm_disparity",
    "SGBMOutput",
]

# np scalar, NOT jnp: a module-level jax array would initialize the
# backend at import time; np.float32 has identical dtype semantics
_BIG = np.float32(1e9)


def xsobel_clipped(img: jax.Array, cap: int = 63) -> jax.Array:
    """OpenCV SGBM prefilter: horizontal Sobel, clipped to [-cap, cap] and
    shifted by +cap (so the neutral response is `cap`). Border columns get
    the neutral value; border rows replicate."""
    img = img.astype(jnp.float32)
    up = jnp.concatenate([img[:1], img[:-1]], axis=0)
    dn = jnp.concatenate([img[1:], img[-1:]], axis=0)
    left = jnp.pad(img[:, :-1], ((0, 0), (1, 0)))
    right = jnp.pad(img[:, 1:], ((0, 0), (0, 1)))
    lu = jnp.pad(up[:, :-1], ((0, 0), (1, 0)))
    ru = jnp.pad(up[:, 1:], ((0, 0), (0, 1)))
    ld = jnp.pad(dn[:, :-1], ((0, 0), (1, 0)))
    rd = jnp.pad(dn[:, 1:], ((0, 0), (0, 1)))
    sob = (right - left) * 2.0 + (ru - lu) + (rd - ld)
    out = jnp.clip(sob, -cap, cap) + cap
    w = img.shape[1]
    xs = jnp.arange(w)[None, :]
    border = (xs == 0) | (xs == w - 1)
    return jnp.where(border, float(cap), out)


def _bt_terms(row_img: jax.Array):
    """Per-pixel (min, max) over {I, (I+I_left)/2, (I+I_right)/2} —
    Birchfield-Tomasi half-pixel envelopes. The half sums are FLOORED like
    OpenCV's integer (a+b)/2, so costs stay integer-valued and uniqueness
    tie behavior matches the reference's int16 arithmetic."""
    left_half = jnp.floor(
        0.5 * (row_img + jnp.concatenate([row_img[:, :1], row_img[:, :-1]], axis=1))
    )
    right_half = jnp.floor(
        0.5 * (row_img + jnp.concatenate([row_img[:, 1:], row_img[:, -1:]], axis=1))
    )
    vmin = jnp.minimum(jnp.minimum(row_img, left_half), right_half)
    vmax = jnp.maximum(jnp.maximum(row_img, left_half), right_half)
    return vmin, vmax


def bt_cost_volume(
    left: jax.Array, right: jax.Array, min_disp: int, num_disp: int
) -> jax.Array:
    """Symmetric Birchfield-Tomasi pixel cost, left reference:
    cost[y, x, d] = BT(left(x), right(x - d)). Out-of-range columns take the
    cost at the clamped column (OpenCV evaluates them against the edge)."""
    lmin, lmax = _bt_terms(left)
    rmin, rmax = _bt_terms(right)

    from .cost import shifted_stack

    r, _ = shifted_stack(right, num_disp, -1, min_disp)
    r_min, _ = shifted_stack(rmin, num_disp, -1, min_disp)
    r_max, _ = shifted_stack(rmax, num_disp, -1, min_disp)

    l = left[:, :, None]
    c0 = jnp.maximum(0.0, jnp.maximum(l - r_max, r_min - l))
    c1 = jnp.maximum(
        0.0, jnp.maximum(r - lmax[:, :, None], lmin[:, :, None] - r)
    )
    return jnp.minimum(c0, c1)


def _pixel_cost(left_gray, right_gray, cfg):
    """Per-pixel SGBM matching cost: BT on the clipped x-Sobel image plus
    BT on raw intensity right-shifted by 2 (OpenCV calcPixelCostBT's
    diff_scale)."""
    sl = xsobel_clipped(left_gray, cfg.prefilter_cap)
    sr = xsobel_clipped(right_gray, cfg.prefilter_cap)
    c = bt_cost_volume(sl, sr, cfg.min_disp, cfg.num_disp)
    # intensity term: integer >>2 (truncation) per pixel, like OpenCV
    return c + jnp.floor(
        bt_cost_volume(left_gray, right_gray, cfg.min_disp, cfg.num_disp) * 0.25
    )


def _block_sum(c, block_size):
    """Block sum with the window clamped to the image (edge-replicated cost
    at borders, OpenCV's convention)."""
    r = block_size // 2
    if r == 0:
        return c
    from .filters import box_filter_sum

    pad = jnp.pad(c, ((r, r), (r, r), (0, 0)), mode="edge")
    s = box_filter_sum(box_filter_sum(pad, r, 0), r, 1)
    return s[r:-r, r:-r]


def sgbm_cost_volume(
    left_gray: jax.Array, right_gray: jax.Array, cfg: SGBMConfig
) -> jax.Array:
    """OpenCV-style SGBM matching cost (pixel BT blend, block-summed)."""
    c = _block_sum(
        _pixel_cost(
            left_gray.astype(jnp.float32), right_gray.astype(jnp.float32), cfg
        ),
        cfg.block_size,
    )
    if cfg.cost_dtype != "float32":
        c = c.astype(cfg.cost_dtype)
    return c


def _dp_candidates(l_prev: jax.Array, m_prev: jax.Array, p1: float, p2: float):
    """min(Lr_prev[d], Lr_prev[d-1]+P1, Lr_prev[d+1]+P1, minLr_prev+P2) - minLr_prev.

    l_prev: (..., D); m_prev: (..., 1) = min over D of l_prev.
    """
    up = jnp.concatenate([jnp.full_like(l_prev[..., :1], _BIG), l_prev[..., :-1]], axis=-1)
    dn = jnp.concatenate([l_prev[..., 1:], jnp.full_like(l_prev[..., :1], _BIG)], axis=-1)
    cand = jnp.minimum(jnp.minimum(l_prev, up + p1), jnp.minimum(dn + p1, m_prev + p2))
    return cand - m_prev


def _scan_block(n: int, want: int = 4) -> int:
    """Largest block size <= want dividing n (scan steps shrink by this)."""
    for k in range(min(want, n), 0, -1):
        if n % k == 0:
            return k
    return 1


def _shift_carry(l, k):
    if k == 0:
        return l
    if k == 1:  # predecessor one column to the left
        return jnp.concatenate([jnp.zeros_like(l[:1]), l[:-1]], axis=0)
    return jnp.concatenate([l[1:], jnp.zeros_like(l[:1])], axis=0)


def _row_scan_dirs(c_rows, init_carry, p1, p2, ndir, reverse: bool = False):
    """Scan rows with an (ndir, W, D) carry (directions: vertical,
    diagonal-from-left, diagonal-from-right). Blocked: each lax.scan step
    consumes a block of rows with the recurrence unrolled inside, so
    per-step overhead amortizes while the carry stays on-chip.

    reverse=True scans bottom-up via lax.scan(reverse=True) — outputs stay
    in ORIGINAL row order, so callers never materialize jnp.flip copies of
    volume-sized arrays (each flip was a full HBM pass).
    Returns (per-row direction-summed Lr (H, W, D), final carry)."""
    h, w, d = c_rows.shape
    kb = _scan_block(h)

    def step(carry, c_block):  # c_block (kb, W, D)
        outs = [None] * kb
        rows = range(kb - 1, -1, -1) if reverse else range(kb)
        for j in rows:
            new = []
            total = None
            for k in range(ndir):
                lp = _shift_carry(carry[k], k)
                mp = jnp.min(lp, axis=-1, keepdims=True)
                l = c_block[j] + _dp_candidates(lp, mp, p1, p2)
                new.append(l)
                total = l if total is None else total + l
            carry = jnp.stack(new)
            outs[j] = total
        return carry, jnp.stack(outs)

    final, ys = jax.lax.scan(
        step, init_carry, c_rows.reshape(h // kb, kb, w, d), reverse=reverse
    )
    return ys.reshape(h, w, d), final


def _col_scans_ew(cost, p1, p2):
    """E and W direction sums (full-width column scans; per-row local).
    One transpose each way; the W direction uses a reversed scan instead
    of flip copies."""
    h, w, d = cost.shape
    kb = _scan_block(w)

    def col_scan(c_cols, reverse):
        def step(lp, c_block):  # (kb, H, D)
            outs = [None] * kb
            rows = range(kb - 1, -1, -1) if reverse else range(kb)
            for j in rows:
                mp = jnp.min(lp, axis=-1, keepdims=True)
                lp = c_block[j] + _dp_candidates(lp, mp, p1, p2)
                outs[j] = lp
            return lp, jnp.stack(outs)

        # derive the zero carry from the input so its sharding "varying"
        # status matches under shard_map (scan requires carry-in == carry-out)
        init = jnp.zeros((h, d), cost.dtype) + 0 * cost[0, 0, 0]
        _, ys = jax.lax.scan(
            step, init, c_cols.reshape(w // kb, kb, h, d), reverse=reverse
        )
        return ys.reshape(w, h, d)

    ct = jnp.swapaxes(cost, 0, 1)
    s = col_scan(ct, False) + col_scan(ct, True)
    return jnp.swapaxes(s, 0, 1)


def aggregate_8path(cost: jax.Array, p1: float, p2: float, num_paths: int = 8) -> jax.Array:
    """Sum of path costs Lr over 8, 5, or 4 directions.

    cost: (H, W, D) -> (H, W, D). Row-wise scans carry the {from-N, from-NW,
    from-NE} (and, for 8 paths, {from-S, from-SE, from-SW}) direction
    states; the diagonal predecessors are the same recurrence with the
    carry shifted one column (border refill = 0, which makes Lr = C there,
    OpenCV's border convention). Two column-wise scans handle E and W.

    num_paths: 8 = MODE_HH (full); 5 = MODE_SGBM's single-pass direction
    set {N, NW, NE, E, W} (matches cv2 MODE_SGBM to D1 ~ 0.05%);
    4 = plain N/S/E/W.
    """
    if num_paths == 8:
        ndir, both = 3, True
    elif num_paths == 5:
        ndir, both = 3, False
    elif num_paths == 4:
        ndir, both = 1, True
    else:
        raise ValueError(f"num_paths must be 4, 5 or 8, got {num_paths}")
    # 0*cost[...] keeps the carry's shard_map varying-axes in sync with cost
    init = jnp.zeros((ndir,) + cost.shape[1:], cost.dtype) + 0 * cost[0, 0, 0]
    s, _ = _row_scan_dirs(cost, init, p1, p2, ndir)
    if both:
        up, _ = _row_scan_dirs(cost, init, p1, p2, ndir, reverse=True)
        s = s + up
    return s + _col_scans_ew(cost, p1, p2)


class SGBMOutput(NamedTuple):
    disparity: jax.Array  # float32, invalid = min_disp - 1
    valid: jax.Array  # bool
    aggregated: jax.Array  # (H, W, D) summed path costs
    # RIGHT-view disparity by min-cost projection — OpenCV's disp2, built
    # anyway for the disp12 cross-check (computeDisparitySGBM's disp2buf);
    # integer-valued, invalid = min_disp - 1, None when disp12 is off.
    # Free right-view seed for the SGBM+3DMST composition
    # (models/sgbm_mst.py right_seed="disp2").
    right_disparity: jax.Array | None = None


def sgbm_disparity(
    left_gray: jax.Array,
    right_gray: jax.Array,
    cfg: SGBMConfig = SGBMConfig(),
    keep_volume: bool = False,
) -> SGBMOutput:
    """Full SGBM disparity for the LEFT view, OpenCV parameter surface.

    Pipeline: cost -> 8-path aggregation -> WTA -> uniqueness ratio ->
    quadratic subpixel -> disp12 cross-check (right disparity derived from
    the same aggregated volume by min-cost projection, as OpenCV does).
    Speckle filtering is a separate op (ops/speckle.py) since it is a
    connected-components pass, not a per-pixel one.
    """
    p1, p2 = cfg.resolved_p1p2()
    c = sgbm_cost_volume(left_gray, right_gray, cfg)
    h, w_full, nd = c.shape
    # OpenCV never evaluates the leftmost maxD = minD + numD columns: its
    # per-row x range starts there, so path scans must not carry state in
    # from that margin. Slice it off before aggregation, pad back after.
    margin = min(cfg.min_disp + nd, w_full)
    s = aggregate_8path(c[:, margin:], float(p1), float(p2), cfg.num_paths)
    w = w_full - margin

    out, valid, rdisp = _select_from_aggregated(s, cfg, margin, w_full)
    agg = s if keep_volume else jnp.zeros((0,), s.dtype)
    return SGBMOutput(out, valid, agg, rdisp)


def _select_from_aggregated(s, cfg, margin, w_full):
    """WTA + uniqueness + subpixel + disp12 from an aggregated volume slice
    (rows are independent, so this works on full images and row bands
    alike). Returns (disparity, valid) padded back to w_full columns."""
    h, w, nd = s.shape
    # WTA + neighbor costs + uniqueness in mask-reduction form: several
    # reductions over the same volume fuse into a couple of memory passes.
    ds = jnp.arange(nd)[None, None, :]
    best = jnp.argmin(s, axis=-1)
    min_s = jnp.min(s, axis=-1)
    b3 = best[..., None]
    pre = jnp.min(jnp.where(ds == b3 - 1, s, _BIG), axis=-1)
    nxt = jnp.min(jnp.where(ds == b3 + 1, s, _BIG), axis=-1)
    pre = jnp.where(best == 0, 0.0, pre)
    nxt = jnp.where(best == nd - 1, 0.0, nxt)

    # uniqueness: any d with S[d]*(100-ratio) < minS*100 and |d - best| > 1
    # invalidates the pixel (OpenCV's exact predicate — bit-for-bit on
    # integer-valued costs).
    if cfg.uniqueness_ratio > 0:
        bad = (s * (100.0 - cfg.uniqueness_ratio) < min_s[..., None] * 100.0) & (
            jnp.abs(ds - b3) > 1
        )
        unique_ok = ~jnp.any(bad, axis=-1)
    else:
        unique_ok = jnp.ones((h, w), bool)

    # quadratic subpixel (OpenCV: denom clamped to >= 1); fp32 regardless
    # of cost_dtype so the offset keeps subpixel resolution
    pre, nxt, min_s = (x.astype(jnp.float32) for x in (pre, nxt, min_s))
    denom = jnp.maximum(pre + nxt - 2.0 * min_s, 1.0)
    offset = (pre - nxt) * 0.5 / denom
    interior = (best > 0) & (best < nd - 1)
    disp = best + cfg.min_disp + jnp.where(interior, offset, 0.0)

    # disp12: right disparity by min-cost projection of surviving left
    # pixels (OpenCV builds disp2 from each valid left pixel's best d via
    # a running min on cost), then cross-check; left pixels whose projected
    # right column has no disp2 entry survive.
    if cfg.disp12_max_diff >= 0:
        xs_local = jnp.arange(w)[None, :]
        xg = xs_local + margin  # global column of each left pixel
        bestd = best + cfg.min_disp
        xr = xg - bestd  # global right column hit
        proj_ok = unique_ok & (xr >= 0) & (xr < w_full)
        ys = jnp.broadcast_to(jnp.arange(h)[:, None], (h, w))
        cost_scatter = jnp.full((h, w_full), _BIG).at[
            ys, jnp.clip(xr, 0, w_full - 1)
        ].min(jnp.where(proj_ok, min_s, _BIG))
        hit_cost = cost_scatter[ys, jnp.clip(xr, 0, w_full - 1)]
        is_winner = proj_ok & (min_s <= hit_cost)
        disp2 = jnp.full((h, w_full), -(2**20)).at[
            ys, jnp.clip(xr, 0, w_full - 1)
        ].max(jnp.where(is_winner, bestd, -(2**20)))
        # OpenCV rounds the subpixel disparity both toward -inf and +inf and
        # checks BOTH right columns x-floor(d) / x-ceil(d) against floor(d) /
        # ceil(d); the pixel is invalidated only if both checks fail (each
        # failure requiring an in-range column with a valid disp2 entry).
        d_floor = jnp.floor(disp).astype(jnp.int32)
        d_ceil = jnp.ceil(disp).astype(jnp.int32)

        def _disp12_fails(dd):
            xr1 = xg - dd
            d2_at = disp2[ys, jnp.clip(xr1, 0, w_full - 1)]
            has = (d2_at > -(2**20)) & (xr1 >= 0) & (xr1 < w_full)
            return has & (jnp.abs(d2_at - dd) > cfg.disp12_max_diff)

        lr_ok = ~(_disp12_fails(d_floor) & _disp12_fails(d_ceil))
        rdisp = jnp.where(
            disp2 > -(2**20), disp2.astype(jnp.float32),
            float(cfg.min_disp - 1),
        )  # (h, w_full) right-view map, already in global columns
    else:
        lr_ok = jnp.ones((h, w), bool)
        rdisp = None

    valid = unique_ok & lr_ok
    invalid_val = float(cfg.min_disp - 1)
    out = jnp.where(valid, disp, invalid_val).astype(jnp.float32)
    # pad the never-evaluated left margin back as INVALID
    out = jnp.pad(out, ((0, 0), (margin, 0)), constant_values=invalid_val)
    valid = jnp.pad(valid, ((0, 0), (margin, 0)), constant_values=False)
    return out.astype(jnp.float32), valid, rdisp


def sgbm_disparity_banded(
    left_gray: jax.Array,
    right_gray: jax.Array,
    cfg: SGBMConfig = SGBMConfig(),
    band_rows: int = 128,
) -> SGBMOutput:
    """SGBM without ever materializing the full aggregated volume: rows are
    processed in bands of `band_rows`, streaming the DP carries between
    bands — the same math as sgbm_disparity with peak memory ~ band volumes
    instead of several full H x W x D volumes. (Band costs are recomputed
    from image strips, so the block-sum cumsum prefixes can differ from the
    monolithic ones by 1 ulp; a near-exact cost tie may then resolve to a
    different disparity on isolated pixels.) This is the production driver
    for 2048x1536x256-scale inputs (SURVEY.md §7 "hard parts" #6).

    Two sweeps: an upward sweep records the {N, NE, NW} carry entering each
    band from below; the downward sweep then finishes each band (down
    directions from the running carry, up directions from the recorded one,
    E/W full-width scans inside the band — rows are independent for those)
    and immediately reduces it to disparity/validity. Cost per band is
    recomputed from a 3-row-padded image strip (Sobel 1 + block 2), so
    band boundaries are seamless.
    """
    p1, p2 = cfg.resolved_p1p2()
    p1, p2 = float(p1), float(p2)
    ndir = 3 if cfg.num_paths in (8, 5) else 1
    use_up = cfg.num_paths != 5  # MODE_SGBM has no upward paths
    left_gray = left_gray.astype(jnp.float32)
    right_gray = right_gray.astype(jnp.float32)
    h, w_full = left_gray.shape
    nd = cfg.num_disp
    margin = min(cfg.min_disp + nd, w_full)
    w = w_full - margin

    pad_h = (-h) % band_rows
    ctx = 3  # sobel (1) + block radius (2)
    lp = jnp.pad(left_gray, ((ctx, ctx + pad_h), (0, 0)), mode="edge")
    rp = jnp.pad(right_gray, ((ctx, ctx + pad_h), (0, 0)), mode="edge")
    hb = h + pad_h
    nbands = hb // band_rows

    def band_cost(b):
        strip_l = jax.lax.dynamic_slice_in_dim(lp, b * band_rows, band_rows + 2 * ctx, 0)
        strip_r = jax.lax.dynamic_slice_in_dim(rp, b * band_rows, band_rows + 2 * ctx, 0)
        cpix = _pixel_cost(strip_l, strip_r, cfg)
        # context rows outside the real image must carry the EDGE row's
        # pixel cost (the full-image block sum edge-replicates COST rows,
        # not image rows — sobel of replicated image rows differs)
        g = b * band_rows - ctx + jnp.arange(band_rows + 2 * ctx)
        src = jnp.clip(g, 0, h - 1) - (b * band_rows - ctx)
        cpix = cpix[jnp.clip(src, 0, band_rows + 2 * ctx - 1)]
        c = _block_sum(cpix, cfg.block_size)
        if cfg.cost_dtype != "float32":
            c = c.astype(cfg.cost_dtype)
        c = c[ctx : ctx + band_rows, margin:]
        # rows beyond the real image get ZERO cost: the DP recurrence maps a
        # zero carry through zero-cost rows to a zero carry, so the padded
        # remainder band is transparent (matches the unpadded zero-carry
        # border initialization exactly)
        grow = b * band_rows + jnp.arange(band_rows)
        return jnp.where((grow < h)[:, None, None], c, 0.0)

    # --- upward sweep: record the up-carry ENTERING each band (from the
    # band below it); skipped entirely for the 5-path MODE_SGBM set ---
    carry0 = jnp.zeros((ndir, w, nd), band_cost(0).dtype)
    if use_up:
        def up_step(carry, b):
            _, new_carry = _row_scan_dirs(
                band_cost(b), carry, p1, p2, ndir, reverse=True
            )
            return new_carry, carry

        _, up_in = jax.lax.scan(
            up_step, carry0, jnp.arange(nbands), reverse=True
        )
        # up_in[b] = carry entering band b (reverse scan stacks in order)

    # --- downward sweep: finish each band and reduce it immediately ---
    def down_step(carry, b):
        c_b = band_cost(b)
        s, new_carry = _row_scan_dirs(c_b, carry, p1, p2, ndir)
        if use_up:
            up_ys, _ = _row_scan_dirs(c_b, up_in[b], p1, p2, ndir, reverse=True)
            s = s + up_ys
        s = s + _col_scans_ew(c_b, p1, p2)
        out_b, valid_b, rdisp_b = _select_from_aggregated(s, cfg, margin, w_full)
        return new_carry, (out_b, valid_b, rdisp_b)

    _, (out, valid, rdisp) = jax.lax.scan(down_step, carry0, jnp.arange(nbands))
    out = out.reshape(hb, w_full)[:h]
    valid = valid.reshape(hb, w_full)[:h]
    if rdisp is not None:
        rdisp = rdisp.reshape(hb, w_full)[:h]
    return SGBMOutput(out, valid, jnp.zeros((0,), jnp.float32), rdisp)
