"""Slanted-plane PatchMatch stereo as iterated parallel propagation.

Data-parallel re-design of the reference's two PatchMatch engines:
  - GPU kernel family (src/PatchMatchStereoGPU.cu:861-998 evaluateCost,
    :1740-2010 stereoMatching, :2602-3023 host): per-pixel slanted-plane
    cost with adaptive color weights exp(-L1/10) and a sign-of-gradient
    census penalty (0.1 per disagreeing tap, +10 for out-of-range taps),
    3x3 spatial propagation, view propagation, annealed plane refinement
    (delta halving from maxDisp/2 to 0.1);
  - CPU pm::PatchMatch (src/pm.cpp): truncated AD+gradient dissimilarity
    (1-a)*min(L1c, tau_c) + a*min(L1g, tau_g), 35x35 window, raster and
    anti-raster sweeps.

The sequential raster sweeps become ITERATED JACOBI PROPAGATION: every
pixel tests its 4 neighbors' planes (shifted plane maps), the other view's
plane at the match point, and annealed random refinements, each round —
converging like the reference's alternating sweeps in a similar number of
rounds but fully parallel (SURVEY.md §7.7). The window is evaluated on a
subsampled tap grid (cfg.tap_stride; the reference's own huber variant
subsamples stride 5, .cu:3126-3128) and never materializes pm.cpp's
rows*cols*35*35 weight tensor (pm.cpp:447-487). RNG is counter-based
jax.random (replacing curand, .cu:2776-2799).

Planes are stored as (nx, ny, d): unit-normal xy components plus the
disparity at the pixel; nz = sqrt(1 - nx^2 - ny^2).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import PatchMatchConfig

__all__ = [
    "PlaneState",
    "plane_cost",
    "patchmatch_stereo",
    "planes_to_disparity",
    "plane_fill_occluded",
    "plane_fill_occluded_best_cost",
]


class PlaneState(NamedTuple):
    nx: jax.Array  # (H, W)
    ny: jax.Array
    d: jax.Array  # disparity at the pixel (positive, own-view convention)


def _nz(nx, ny):
    return jnp.sqrt(jnp.maximum(1.0 - nx * nx - ny * ny, 1e-8))


def planes_to_disparity(p: PlaneState) -> jax.Array:
    return p.d


def _sample_x(img, xf, y_idx):
    """Linear interpolation of img (H, W) along x at float columns xf
    (H, W), rows fixed (the reference reads linear-filtered textures)."""
    w = img.shape[1]
    x0 = jnp.floor(xf)
    frac = xf - x0
    x0i = jnp.clip(x0.astype(jnp.int32), 0, w - 1)
    x1i = jnp.clip(x0i + 1, 0, w - 1)
    v0 = jnp.take_along_axis(img, x0i, axis=1)
    v1 = jnp.take_along_axis(img, x1i, axis=1)
    return v0 * (1.0 - frac) + v1 * frac


def plane_cost(
    base_bgr: jax.Array,  # (H, W, 3) in [0, 255]
    base_gray: jax.Array,  # (H, W)
    match_gray: jax.Array,  # (H, W)
    planes: PlaneState,
    cfg: PatchMatchConfig,
    sign: int,  # -1 left base (match at x - d), +1 right base
    match_bgr: jax.Array | None = None,  # needed for metric="adgrad"
    base_grad: jax.Array | None = None,  # (H, W, 2) forward gradients
    match_grad: jax.Array | None = None,
) -> jax.Array:
    """Window cost of a plane map.

    metric="grad_sign" (GPU evaluateCost semantics,
    src/PatchMatchStereoGPU.cu:861-998, active #if 1 metric): per tap,
    adaptive weight exp(-L1_bgr(center, tap)/10) and penalty 0.1 where the
    base and match gray increments disagree in sign; out-of-range taps add
    10.0 with weight 1.

    metric="adgrad" (CPU pm::PatchMatch dissimilarity, src/pm.cpp:97-160):
    same adaptive weights, penalty (1-alpha)*min(L1_bgr/ch, tau_c)
    + alpha*min(L1_grad, tau_g); out-of-range taps cost plane_penalty.
    Returns (H, W) cost."""
    h, w = base_gray.shape
    r = cfg.window_size // 2
    stride = cfg.tap_stride
    taps = [(dy, dx) for dy in range(-r, r + 1, stride) for dx in range(-r, r + 1, stride)]

    nx, ny, d = planes
    nz = _nz(nx, ny)
    af = -nx / nz
    bf = -ny / nz
    xs = jnp.arange(w, dtype=jnp.float32)[None, :]
    ys = jnp.arange(h, dtype=jnp.float32)[:, None]
    cf = (nx * xs + ny * ys + nz * d) / nz
    d_center = af * xs + bf * ys + cf
    center_ok = (
        (d_center >= cfg.min_disp)
        & (d_center <= cfg.max_disp)
        & (xs + sign * d_center >= 0)
        & (xs + sign * d_center < w)
    )
    match_center_x = xs + sign * d_center
    g_base_c = base_gray
    g_match_c = _sample_x(match_gray, jnp.clip(match_center_x, 0, w - 1), None)

    # feature storage dtype: the padded maps below are re-read (streamed
    # slices + x-interp gathers) once per tap x candidate — the dominant
    # PatchMatch bytes. bf16 halves them; all arithmetic returns to f32
    # right after each load (PatchMatchConfig.feature_dtype).
    fdt = jnp.dtype(cfg.feature_dtype)
    f32 = lambda x: x.astype(jnp.float32)  # noqa: E731

    pad_spec = ((r, r), (r, r))
    gray_p = jnp.pad(base_gray, pad_spec, mode="edge").astype(fdt)
    bgr_p = jnp.pad(base_bgr, pad_spec + ((0, 0),), mode="edge").astype(fdt)
    match_p = jnp.pad(match_gray, pad_spec, mode="edge").astype(fdt)  # pad rows for y+h
    adgrad = cfg.metric == "adgrad"
    if adgrad:
        bgrad_p = jnp.pad(base_grad, pad_spec + ((0, 0),), mode="edge").astype(fdt)
        # match color + gradient coalesced into ONE (H, W, 5) feature map:
        # each tap then needs a single 5-channel x-interp gather pair
        # instead of 5 separate per-channel gathers
        mfeat_p = jnp.pad(
            jnp.concatenate([match_bgr, match_grad], axis=-1),
            pad_spec + ((0, 0),),
            mode="edge",
        ).astype(fdt)
    base_bgr_f = base_bgr.astype(fdt)  # center colors for the tap weights

    offs = jnp.asarray(taps, jnp.int32)
    oob_cost = cfg.plane_penalty if adgrad else 10.0

    def tap_step(carry, off):
        cost_acc, w_acc = carry
        dy, dx = off[0], off[1]
        base_tap_g = f32(jax.lax.dynamic_slice(gray_p, (dy + r, dx + r), (h, w)))
        base_tap_c = jax.lax.dynamic_slice(bgr_p, (dy + r, dx + r, 0), (h, w, 3))
        d_tap = af * (xs + dx) + bf * (ys + dy) + cf
        ok = (
            center_ok
            & (d_tap >= cfg.min_disp)
            & (d_tap <= cfg.max_disp)
            & (xs + sign * d_tap >= 0)
            & (xs + sign * d_tap < w)
        )
        # |a - b| computed in the storage dtype (exact for the f32 default;
        # ~1 gray level quantization at bf16), everything after in f32
        weight = jnp.exp(
            -f32(jnp.sum(jnp.abs(base_bgr_f - base_tap_c), axis=-1)) / cfg.gamma
        )
        mx = jnp.clip(xs + dx + sign * d_tap, 0, w - 1)
        if adgrad:
            base_tap_grad = jax.lax.dynamic_slice(
                bgrad_p, (dy + r, dx + r, 0), (h, w, 2)
            )
            feat = jax.lax.dynamic_slice(mfeat_p, (dy + r, r, 0), (h, w, 5))
            x0 = jnp.floor(mx)
            frac = (mx - x0)[..., None]
            x0i = jnp.clip(x0.astype(jnp.int32), 0, w - 1)[..., None]
            v0 = f32(jnp.take_along_axis(feat, x0i, axis=1))
            v1 = f32(jnp.take_along_axis(feat, jnp.clip(x0i + 1, 0, w - 1), axis=1))
            m_feat = v0 * (1.0 - frac) + v1 * frac  # (H, W, 5) f32
            c_l1 = jnp.sum(jnp.abs(f32(base_tap_c) - m_feat[..., :3]), axis=-1)
            g_l1 = jnp.sum(jnp.abs(f32(base_tap_grad) - m_feat[..., 3:]), axis=-1)
            penalty = (1.0 - cfg.alpha) * jnp.minimum(
                c_l1, cfg.tau_c
            ) + cfg.alpha * jnp.minimum(g_l1, cfg.tau_g)
        else:
            # match gray at (y + dy, x + dx + sign*d_tap), linear in x
            match_shift = f32(jax.lax.dynamic_slice(match_p, (dy + r, r), (h, w)))
            match_tap = _sample_x(match_shift, mx, None)
            sign_disagree = (g_base_c - base_tap_g) * (g_match_c - match_tap) < 0.0
            penalty = jnp.where(sign_disagree, 0.1, 0.0)
        cost_acc = cost_acc + jnp.where(ok, weight * penalty, oob_cost)
        w_acc = w_acc + jnp.where(ok, weight, 1.0)
        return (cost_acc, w_acc), None

    init = (jnp.zeros((h, w)), jnp.zeros((h, w)))
    (cost, wsum), _ = jax.lax.scan(tap_step, init, offs)
    return cost / wsum


def plane_fill_occluded(planes: PlaneState, valid: jax.Array) -> jax.Array:
    """Occlusion fill with PLANES, not constants: each invalid pixel takes
    the nearest valid pixel's plane on its row from the left and right,
    EXTENDS both planes to its own (x, y), and keeps the lower disparity
    (background wins) — the reference's fill (pm.cpp:367-392; GPU variant
    scans for valid planes at .cu:2190-2224). Returns the disparity map.

    The sequential while-loop searches become two directional index scans.
    """
    nx, ny, d = planes
    h, w = d.shape
    xs = jnp.broadcast_to(jnp.arange(w)[None, :], (h, w))
    ys = jnp.broadcast_to(jnp.arange(h)[:, None], (h, w))

    left_idx = jax.lax.cummax(jnp.where(valid, xs, -1), axis=1)
    right_idx = jax.lax.cummin(jnp.where(valid, xs, w), axis=1, reverse=True)
    has_l, has_r = left_idx >= 0, right_idx < w

    def extend(src_idx):
        sx = jnp.clip(src_idx, 0, w - 1)
        g = lambda a: jnp.take_along_axis(a, sx, axis=1)  # noqa: E731
        snx, sny, sd = g(nx), g(ny), g(d)
        nz = _nz(snx, sny)
        af, bf = -snx / nz, -sny / nz
        cf = (snx * sx + sny * ys + nz * sd) / nz
        return af * xs + bf * ys + cf

    d_l = extend(left_idx)
    d_r = extend(right_idx)
    fill = jnp.where(
        has_l & has_r,
        jnp.minimum(d_l, d_r),
        jnp.where(has_l, d_l, jnp.where(has_r, d_r, 0.0)),
    )
    return jnp.where(valid, d, fill)


def plane_fill_occluded_best_cost(
    planes: PlaneState,
    valid: jax.Array,
    base_bgr: jax.Array,
    base_gray: jax.Array,
    match_gray: jax.Array,
    cfg: PatchMatchConfig,
    sign: int,
    k: int = 4,
    match_bgr: jax.Array | None = None,
    base_grad: jax.Array | None = None,
    match_grad: jax.Array | None = None,
) -> jax.Array:
    """GPU-style occlusion fill: each occluded pixel takes the VALID donor
    whose (normal, disparity) evaluates to the lowest window cost AT this
    pixel (ref: fillInOccluded scanning +-cols/4 on the row and keeping the
    min-evaluateCost candidate, src/PatchMatchStereoGPU.cu:2190-2224; the
    donor's own disparity value is used directly, not plane-extended).

    Parallel redesign: instead of a serial +-cols/4 scan per pixel, the candidate
    set is the k nearest valid pixels on each side (occlusions are
    contiguous spans, so near donors dominate the reference's scan), each
    found by iterating the nearest-valid index scan: L_{j+1}[x] =
    L_1[L_j[x] - 1]. Each of the 2k donors costs one vectorized plane_cost
    pass. Donors beyond +-W/4 are excluded like the reference; pixels with
    no in-range donor fall back to disparity 0 (ref best_disp init,
    .cu:2185). Returns the filled disparity map.
    """
    nx, ny, d = planes
    h, w = d.shape
    xs = jnp.broadcast_to(jnp.arange(w)[None, :], (h, w))
    max_reach = w // 4

    l1 = jax.lax.cummax(jnp.where(valid, xs, -1), axis=1)
    r1 = jax.lax.cummin(jnp.where(valid, xs, w), axis=1, reverse=True)

    donor_idx = []
    lj, rj = l1, r1
    for _ in range(k):
        donor_idx.append(lj)
        donor_idx.append(rj)
        # next-nearest: re-read the first-nearest scan one column past the
        # current donor (sentinels -1 / w propagate naturally via clip+mask)
        lj = jnp.where(
            lj > 0, jnp.take_along_axis(l1, jnp.clip(lj - 1, 0, w - 1), axis=1), -1
        )
        rj = jnp.where(
            rj < w - 1,
            jnp.take_along_axis(r1, jnp.clip(rj + 1, 0, w - 1), axis=1),
            w,
        )

    best_cost = jnp.full((h, w), 1e10)
    best_disp = jnp.zeros((h, w))
    for idx in donor_idx:
        in_range = (idx >= 0) & (idx < w) & (jnp.abs(idx - xs) <= max_reach)
        sx = jnp.clip(idx, 0, w - 1)
        g = lambda a: jnp.take_along_axis(a, sx, axis=1)  # noqa: E731
        cand = PlaneState(g(nx), g(ny), g(d))
        c = plane_cost(
            base_bgr, base_gray, match_gray, cand, cfg, sign,
            match_bgr=match_bgr, base_grad=base_grad, match_grad=match_grad,
        )
        c = jnp.where(in_range, c, 1e10)
        better = c < best_cost
        best_cost = jnp.where(better, c, best_cost)
        best_disp = jnp.where(better, cand.d, best_disp)

    return jnp.where(valid, d, best_disp)


def _view_transform(other: PlaneState, sign: int, w: int) -> PlaneState:
    """Plane candidates from the other view: each pixel takes the other
    view's plane at its match column (ref: view propagation,
    .cu:1799-1827 — the matched pixel's plane and ITS disparity value)."""
    xs = jnp.arange(w)[None, :]
    # the reference indexes the other view at x + round(d_other_map(x)) —
    # the OTHER view's disparity read at the SAME column (.cu:1802).
    mx = jnp.clip(xs + sign * jnp.round(other.d).astype(jnp.int32), 0, w - 1)
    take = lambda a: jnp.take_along_axis(a, mx, axis=1)  # noqa: E731
    return PlaneState(take(other.nx), take(other.ny), take(other.d))


@partial(jax.jit, static_argnames=("cfg", "iterations"))
def patchmatch_stereo(
    key: jax.Array,
    left_bgr: jax.Array,
    right_bgr: jax.Array,
    cfg: PatchMatchConfig = PatchMatchConfig(),
    iterations: int | None = None,
):
    """Run PatchMatch on a rectified BGR pair in [0, 255].

    Returns (left: PlaneState, right: PlaneState, left_cost, right_cost).
    Iterations follow the reference loop (.cu:2810-2826) with Jacobi
    propagation instead of in-place sweeps; refinement deltas anneal by
    halving per candidate within each round (.cu:1831-1884).
    """
    iters = cfg.iterations if iterations is None else iterations
    h, w = left_bgr.shape[:2]
    gray_l = 0.114 * left_bgr[..., 0] + 0.587 * left_bgr[..., 1] + 0.299 * left_bgr[..., 2]
    gray_r = 0.114 * right_bgr[..., 0] + 0.587 * right_bgr[..., 1] + 0.299 * right_bgr[..., 2]

    def rand_init(k):
        k1, k2, k3 = jax.random.split(k, 3)
        d = jax.random.uniform(k1, (h, w), minval=cfg.min_disp, maxval=cfg.max_disp)
        # hemisphere normals via polar disc sampling (ref .cu:2782-2799)
        rr = jnp.sqrt(jax.random.uniform(k2, (h, w)))
        th = jax.random.uniform(k3, (h, w)) * (2 * jnp.pi)
        x1, x2 = rr * jnp.cos(th), rr * jnp.sin(th)
        s = jnp.sqrt(jnp.maximum(1.0 - x1 * x1 - x2 * x2, 0.0))
        return PlaneState(2.0 * x1 * s, 2.0 * x2 * s, d)

    kl, kr, kloop = jax.random.split(key, 3)
    left = rand_init(kl)
    right = rand_init(kr)

    if cfg.metric == "adgrad":
        # central-difference gray gradients (the role of pm.cpp's Sobel/8,
        # compute_greyscale_gradient, pm.cpp:70-88)
        def grad2(g):
            gx = jnp.gradient(g, axis=1)
            gy = jnp.gradient(g, axis=0)
            return jnp.stack([gx, gy], axis=-1)

        grad_l, grad_r = grad2(gray_l), grad2(gray_r)
    else:
        grad_l = grad_r = None

    def cost_of(planes, base, sign):
        if base == 0:
            return plane_cost(
                left_bgr, gray_l, gray_r, planes, cfg, sign,
                match_bgr=right_bgr, base_grad=grad_l, match_grad=grad_r,
            )
        return plane_cost(
            right_bgr, gray_r, gray_l, planes, cfg, sign,
            match_bgr=left_bgr, base_grad=grad_r, match_grad=grad_l,
        )

    cost_l = cost_of(left, 0, -1)
    cost_r = cost_of(right, 1, +1)

    def shift_planes(p: PlaneState, dy: int, dx: int) -> PlaneState:
        def sh(a):
            a = jnp.roll(a, (dy, dx), axis=(0, 1))
            return a

        return PlaneState(sh(p.nx), sh(p.ny), sh(p.d))

    n_refine = []
    md = 0.5 * cfg.max_disp
    mn = 1.0
    while md >= 0.1:
        n_refine.append((md, mn))
        md, mn = md * 0.5, mn * 0.5
    deltas = jnp.asarray(n_refine, jnp.float32)  # (R, 2)

    def update_view(key_i, jump, planes, cost, other, base, sign):
        def try_candidate(state, cand: PlaneState):
            pl, c = state
            c_new = cost_of(cand, base, sign)
            better = c_new < c
            pl = PlaneState(
                jnp.where(better, cand.nx, pl.nx),
                jnp.where(better, cand.ny, pl.ny),
                jnp.where(better, cand.d, pl.d),
            )
            return (pl, jnp.where(better, c_new, c))

        state = (planes, cost)
        # spatial propagation: 4-neighborhood plane maps PLUS 4 long-range
        # "jump" candidates at a per-iteration distance (descending powers
        # of two). Jacobi unit-neighbor exchange moves information 1 px per
        # round, while the reference's raster sweeps cross the image in ONE
        # kernel launch (.cu:1762-1765, pm.cpp:497-514) — jump flooding is
        # the standard parallel substitute that restores that reach in
        # O(log max(H, W)) rounds. The candidate plane's d is re-evaluated
        # at OUR pixel through its (a, b, c).
        for dy, dx in (
            (1, 0), (-1, 0), (0, 1), (0, -1),
            (jump, 0), (-jump, 0), (0, jump), (0, -jump),
        ):
            nb = shift_planes(planes, dy, dx)
            nz = _nz(nb.nx, nb.ny)
            xs = jnp.arange(w, dtype=jnp.float32)[None, :]
            ys = jnp.arange(h, dtype=jnp.float32)[:, None]
            # plane through neighbor's (x - dx, y - dy) extended to (x, y)
            af, bf = -nb.nx / nz, -nb.ny / nz
            cf = (nb.nx * (xs - dx) + nb.ny * (ys - dy) + nz * nb.d) / nz
            d_here = af * xs + bf * ys + cf
            state = try_candidate(state, PlaneState(nb.nx, nb.ny, d_here))

        # view propagation
        state = try_candidate(state, _view_transform(other, sign, w))

        # annealed refinement
        def refine(j, st):
            pl, c = st
            kj = jax.random.fold_in(key_i, j)
            u = jax.random.uniform(kj, (4, h, w), minval=-1.0, maxval=1.0)
            dd, dn = deltas[j, 0], deltas[j, 1]
            nd = pl.d + u[0] * dd
            nx = pl.nx + u[1] * dn
            ny = pl.ny + u[2] * dn
            nz0 = _nz(pl.nx, pl.ny) + u[3] * dn
            norm = jnp.sqrt(nx * nx + ny * ny + nz0 * nz0)
            nx, ny = nx / norm, ny / norm
            ok = (nd >= cfg.min_disp) & (nd <= cfg.max_disp) & (nx * nx + ny * ny < 1.0)
            cand = PlaneState(
                jnp.where(ok, nx, pl.nx),
                jnp.where(ok, ny, pl.ny),
                jnp.where(ok, nd, pl.d),
            )
            return try_candidate(st, cand)

        state = jax.lax.fori_loop(0, deltas.shape[0], refine, state)
        return state

    def round_(carry, inp):
        key_i, jump = inp
        left, right, cost_l, cost_r = carry
        k1, k2 = jax.random.split(key_i)
        left, cost_l = update_view(k1, jump, left, cost_l, right, 0, -1)
        right, cost_r = update_view(k2, jump, right, cost_r, left, 1, +1)
        return (left, right, cost_l, cost_r), None

    keys = jax.random.split(kloop, iters)
    # jump-flood schedule: max(H, W)/4 halving to 2, cycled if iters exceeds
    # the number of levels
    m = max(h, w) // 4
    levels = [max(2, m >> k) for k in range(max(1, m.bit_length() - 1))]
    jumps = jnp.asarray(
        [levels[k % len(levels)] for k in range(iters)], jnp.int32
    )
    (left, right, cost_l, cost_r), _ = jax.lax.scan(
        round_, (left, right, cost_l, cost_r), (keys, jumps)
    )
    return left, right, cost_l, cost_r
