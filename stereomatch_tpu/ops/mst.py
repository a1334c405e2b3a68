"""3DMST tree-filter cost aggregation + plane-label optimization.

Data-parallel re-design of the reference's Stereo3DMST hot loop
(src/Stereo3DMST.cpp:103-186, :546-629; SURVEY.md §3.2). The reference does,
per tree and per candidate label, two sequential O(N) tree passes
(leaf->root `agg[par] += w*agg[child]`, then root->leaf
`agg[child] = w*agg[par] + (1-w^2)*agg[child]`), parallelized over trees
with OpenMP. Here the SAME aggregation for ALL trees and a whole BATCH of
candidate labels runs as a handful of prefix sums:

Because every tree-edge weight is exp(-gamma * color_diff), the weight
product along any tree path telescopes to exp(-gamma * pathlength). The
leaf->root pass U(p) = c(p) + sum_ch w_ch U(ch) therefore equals
    U(p) = e^{+g(p)} * sum_{q in subtree(p)} e^{-g(q)} c(q),
a SUBTREE sum, and subtrees are contiguous ranges of the Euler tour —
one cumsum. The root->leaf pass
    D(p) = w_p D(parent) + (1 - w_p^2) U(p)
expands to an ANCESTOR sum, which is the classic Euler +enter/-exit prefix
trick — a second cumsum. g(p) is gamma * weighted depth.

fp32 range: the host builder (native/treebuild.cpp) splits trees into
segments whose depth range is <= delta (default 40), so every exponential
stays within e^{±40}. Aggregation across a split is restored exactly (to
e^{-delta}, i.e. ~4e-18 — below fp32 resolution of any term) by ONE carry
injection per direction: any path crossing two splits has weight
<= e^{-delta} by construction.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import MSTConfig

__all__ = [
    "ForestArrays",
    "forest_arrays",
    "tree_filter",
    "aggregation_norm_inv",
    "label_cost",
    "labels_to_disparity",
    "plane_labels_from_disparity",
    "mst_pms_optimize",
    "refine_deltas",
    "make_candidate_fn",
]


class SegScanMaps(NamedTuple):
    """Static index maps driving the one-pass blocked segmented cumsum
    (_segmented_cumsum_mm). All derived host-side from the (static) reset
    positions of a forest, so the on-device scan needs no flag combines:
    within-block prefixes come from ONE triangular matmul, and the
    segment restarts become two static gathers + one tiny per-block carry
    scan."""

    corr_idx: jax.Array  # (Mp,) int32: padded-P index of P[last_reset-1]
    has_corr: jax.Array  # (Mp,) bool: last reset falls inside this block
    needs_carry: jax.Array  # (Mp,) bool: segment opened before this block
    blk_reset: jax.Array  # (nb,) bool: block contains a reset
    blk_has_corr: jax.Array  # (nb,) bool: last reset strictly after blk start
    blk_corr_idx: jax.Array  # (nb,) int32: padded-P index for the blk total


class ForestArrays(NamedTuple):
    """Device-side flat forest (see native.Forest for field semantics).

    Node order is concatenated per-segment DFS preorder and every
    segment's nodes AND Euler events are contiguous ranges (invariants of
    native/treebuild.cpp's merged DFS; checked in tests/test_mst.py) —
    sub_end and the scan maps below depend on them."""

    pixel_of_node: jax.Array  # (N,) int32
    parent_node: jax.Array  # (N,) int32
    w_exp: jax.Array  # (N,) f32
    rel_gd: jax.Array  # (N,) f32
    in_pos: jax.Array  # (N,) int32
    out_pos: jax.Array  # (N,) int32
    tree_id: jax.Array  # (N,) int32
    seg_root: jax.Array  # (N,) bool
    euler_reset: jax.Array  # (2N,) bool, True at each segment's first event
    euler_src: jax.Array  # (2N,) int32: the node whose in/out event this is
    euler_is_in: jax.Array  # (2N,) bool: True at in events
    # cross-cut carry maps, GATHER form: node p's cut children (segment
    # roots whose parent is p). Grid degree bounds these at 3 per node
    # (4-neighbour tree, one edge to the parent), so the per-round carry
    # injection is 3 static gathers instead of an Sc-sized scatter-add —
    # Sc is ~N/2 on textured images (delta=4 splits aggressively).
    cut_child_idx: jax.Array  # (3, N) int32: k-th cut child (self if none)
    cut_child_w: jax.Array  # (3, N) f32: its w_exp (0 if none)
    tree_start: jax.Array  # (T+1,) int32 (padded to Tmax+1)
    adj_start: jax.Array  # (T+1,) int32
    adj_list: jax.Array  # (M,) int32
    sub_end: jax.Array  # (N,) int32: p's within-segment subtree = [p, sub_end)
    nscan: SegScanMaps  # maps for N-length node-order scans (up-sweep)
    escan: SegScanMaps  # maps for 2N-length Euler-event scans (down-sweep)
    num_trees: int  # static
    height: int
    width: int


_SCAN_BLOCK = 256  # triangular-matmul scan block (lane-aligned; see
# _segmented_cumsum_mm — flops/scan scale with the block size, conditioning
# bounds with block * e^{max_log_range})


def _make_scan_maps(reset: np.ndarray, block: int = _SCAN_BLOCK) -> SegScanMaps:
    """Host-side static maps for _segmented_cumsum_mm over a sequence with
    the given (static) reset positions. reset[0] must be True."""
    m = reset.size
    assert reset[0], "sequence must open with a segment"
    pad = (-m) % block
    mp = m + pad
    r = np.zeros(mp, bool)
    r[:m] = reset
    r[m:] = True  # pad region is its own dead segment
    idx = np.arange(mp)
    lrs = np.maximum.accumulate(np.where(r, idx, -1))  # last reset <= idx
    blk_start = (idx // block) * block
    has_corr = lrs - 1 >= blk_start  # reset strictly inside this block
    corr_idx = np.where(has_corr, lrs - 1, 0).astype(np.int32)
    needs_carry = lrs < blk_start  # segment opened in an earlier block
    nb = mp // block
    lrs_end = lrs.reshape(nb, block)[:, -1]
    bs = blk_start.reshape(nb, block)[:, 0]
    blk_reset = lrs_end >= bs
    blk_has_corr = lrs_end > bs
    blk_corr_idx = np.where(blk_has_corr, lrs_end - 1, 0).astype(np.int32)
    return SegScanMaps(
        corr_idx=jnp.asarray(corr_idx),
        has_corr=jnp.asarray(has_corr),
        needs_carry=jnp.asarray(needs_carry),
        blk_reset=jnp.asarray(blk_reset),
        blk_has_corr=jnp.asarray(blk_has_corr),
        blk_corr_idx=jnp.asarray(blk_corr_idx),
    )


def forest_arrays(forest) -> ForestArrays:
    """Upload a native.Forest to device arrays."""
    n = forest.height * forest.width
    seg_root = forest.seg_root_mask()
    euler_reset = np.zeros(2 * n, bool)
    euler_reset[forest.in_pos[seg_root]] = True
    # every Euler position is the in- OR out-event of exactly one node;
    # precomputing that (static) map turns the per-pass event scatters
    # into gathers
    euler_src = np.zeros(2 * n, np.int32)
    euler_is_in = np.zeros(2 * n, bool)
    euler_src[forest.in_pos] = np.arange(n, dtype=np.int32)
    euler_src[forest.out_pos] = np.arange(n, dtype=np.int32)
    euler_is_in[forest.in_pos] = True
    # carry-injection support: only NON-tree-root segment roots inject
    # carries across cuts. Inverted to gather form: for each node, its
    # (at most 3) cut children — see ForestArrays.cut_child_idx.
    is_tree_root = forest.parent_node == np.arange(n, dtype=np.int32)
    sc_nodes = np.nonzero(seg_root & ~is_tree_root)[0].astype(np.int32)
    sc_parent = forest.parent_node[sc_nodes]
    cut_child_idx = np.tile(np.arange(n, dtype=np.int32), (3, 1))
    cut_child_w = np.zeros((3, n), np.float32)
    if sc_nodes.size:
        order = np.argsort(sc_parent, kind="stable")
        sp = sc_parent[order]
        sn = sc_nodes[order]
        first = np.concatenate([[True], sp[1:] != sp[:-1]])
        run_start = np.maximum.accumulate(
            np.where(first, np.arange(sp.size), 0)
        )
        slot = np.arange(sp.size) - run_start
        assert slot.max() < 3, "grid tree node cannot have >3 cut children"
        cut_child_idx[slot, sp] = sn
        cut_child_w[slot, sp] = forest.w_exp[sn]
    # keep adj_list non-empty so gathers are well-formed when the forest is
    # a single tree with no neighbors
    adj_list = forest.adj_list
    if adj_list.size == 0:
        adj_list = np.zeros(1, np.int32)
    # within-segment subtree of node p (preorder-contiguous, = [p, sub_end)):
    # the Euler bracket [in(p), out(p)] holds exactly its 2k events because
    # cut children live in their own contiguous segment ranges
    sub_end = (
        np.arange(n, dtype=np.int32)
        + ((forest.out_pos - forest.in_pos + 1) // 2).astype(np.int32)
    )
    return ForestArrays(
        pixel_of_node=jnp.asarray(forest.pixel_of_node),
        parent_node=jnp.asarray(forest.parent_node),
        w_exp=jnp.asarray(forest.w_exp),
        rel_gd=jnp.asarray(forest.rel_gd),
        in_pos=jnp.asarray(forest.in_pos),
        out_pos=jnp.asarray(forest.out_pos),
        tree_id=jnp.asarray(forest.tree_id),
        seg_root=jnp.asarray(seg_root),
        euler_reset=jnp.asarray(euler_reset),
        euler_src=jnp.asarray(euler_src),
        euler_is_in=jnp.asarray(euler_is_in),
        cut_child_idx=jnp.asarray(cut_child_idx),
        cut_child_w=jnp.asarray(cut_child_w),
        tree_start=jnp.asarray(forest.tree_start),
        adj_start=jnp.asarray(forest.adj_start),
        adj_list=jnp.asarray(adj_list),
        sub_end=jnp.asarray(sub_end),
        nscan=_make_scan_maps(seg_root),
        escan=_make_scan_maps(euler_reset),
        num_trees=forest.num_trees,
        height=forest.height,
        width=forest.width,
    )


def _segmented_cumsum_mm(
    x: jax.Array, maps: SegScanMaps, block: int = _SCAN_BLOCK
) -> jax.Array:
    """Inclusive prefix sum along the last axis restarting at the (static)
    segment starts encoded in `maps`.

    Within-block inclusive prefixes are ONE triangular matmul (instead
    of the log2(block) read+write combine levels of an associative_scan
    — the scan becomes a single read and write of the array, plus
    `block` multiply-adds per element). Precision.HIGHEST keeps the f32
    product exact to f32 rounding: at default precision a GPU may run it
    in TF32 (10-bit mantissa), far above the bound below. Segment
    restarts are applied afterwards from static gathers:

        out[j] = P[j] - P[last_reset(j) - 1]          (reset in block)
               = P[j] + carry[block(j)]               (segment from before)

    with a tiny (value, flag) scan over per-block totals for the carries.

    Conditioning: raw within-block prefixes accumulate at most `block`
    terms before correction, so cancellation error is ~eps * block * max|x|
    — with block=256 and |x| <= e^{max_log_range} * 0.5 this sits at the
    same ~3e-4 noise floor as the exp-factorization itself (see
    tree_filter). The result is the same reassociated sum as the previous
    blocked associative scan.
    """
    m = x.shape[-1]
    mp = maps.corr_idx.shape[0]
    if mp != m:
        x = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, mp - m)])
    nb = mp // block
    xb = x.reshape(x.shape[:-1] + (nb, block))
    tri = jnp.asarray(np.triu(np.ones((block, block), np.float32)))
    p = jax.lax.dot_general(
        xb,
        tri,
        (((xb.ndim - 1,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
    )  # (..., nb, block) inclusive within-block prefixes
    pf = p.reshape(x.shape[:-1] + (mp,))
    base = jnp.where(maps.has_corr, pf[..., maps.corr_idx], 0.0)
    tot = p[..., -1] - jnp.where(
        maps.blk_has_corr, pf[..., maps.blk_corr_idx], 0.0
    )  # per-block sum of the segment open at the block end

    def comb(a, b):
        av, af = a
        bv, bf = b
        return jnp.where(bf, bv, av + bv), af | bf

    flags = jnp.broadcast_to(maps.blk_reset, tot.shape)
    cv, _ = jax.lax.associative_scan(comb, (tot, flags), axis=-1)
    carry = jnp.concatenate([jnp.zeros_like(cv[..., :1]), cv[..., :-1]], axis=-1)
    carry_pos = jnp.broadcast_to(
        carry[..., None], carry.shape + (block,)
    ).reshape(x.shape[:-1] + (mp,))
    out = pf - base + jnp.where(maps.needs_carry, carry_pos, 0.0)
    return out[..., :m] if mp != m else out


def segmented_cumsum_reference(x: np.ndarray, reset: np.ndarray) -> np.ndarray:
    """Plain float64 oracle for _segmented_cumsum_mm: the inclusive cumsum
    of each segment (a segment opens at every True of `reset`)."""
    x = np.asarray(x, np.float64)
    idx = np.arange(reset.size)
    start = np.maximum.accumulate(np.where(reset, idx, 0))
    c = np.cumsum(x, axis=-1)
    before = np.where(start > 0, c[..., np.maximum(start - 1, 0)], 0.0)
    return c - before


def segmented_cumsum_tolerance(
    x: np.ndarray, reset: np.ndarray, block: int = _SCAN_BLOCK
) -> np.ndarray:
    """Per-element f32 error bound of _segmented_cumsum_mm, as its
    docstring derives it: eps * block * max|x| for the within-block
    prefix, plus the same again for each earlier block total the segment
    carries in (4x slack for the rounding of the carry adds)."""
    idx = np.arange(reset.size)
    start = np.maximum.accumulate(np.where(reset, idx, 0))
    crossed = idx // block - start // block
    eps = float(np.finfo(np.float32).eps)
    return 4.0 * eps * block * float(np.max(np.abs(x))) * (1.0 + crossed)


def _subtree_sums(t: jax.Array, f: ForestArrays) -> jax.Array:
    """sum over subtree(p) (within segment) of t(q).

    t: (..., N) values in node order. Returns (..., N). Node order is
    per-segment preorder, so the within-segment subtree of p is the
    contiguous node range [p, sub_end(p)) — an N-length segmented prefix
    difference, half the events of the Euler formulation."""
    p = _segmented_cumsum_mm(t, f.nscan)
    p_end = p[..., f.sub_end - 1]
    p_self = p - t  # exclusive prefix at p
    return p_end - p_self


def _ancestor_sums(v: jax.Array, f: ForestArrays) -> jax.Array:
    """sum over ancestors-or-self (within segment) of v(a), via Euler
    +enter/-exit prefix. v: (..., N) -> (..., N)."""
    n = v.shape[-1]
    shape = v.shape[:-1] + (n,)
    # gather formulation: +v at in events, -v at out events
    b = jnp.where(f.euler_is_in, v[..., f.euler_src], -v[..., f.euler_src])
    q = _segmented_cumsum_mm(b, f.escan)
    return jnp.take_along_axis(q, jnp.broadcast_to(f.in_pos, shape), -1)


def tree_filter(
    c_node: jax.Array,
    f: ForestArrays,
    carry_iters: int = 2,
) -> jax.Array:
    """Yang-style tree-filter aggregation D for all trees at once.

    c_node: (..., N) per-node costs (node order). Returns (..., N) with the
    same result as the reference's two-pass recurrence
    (Stereo3DMST.cpp:120-158).

    Numerics: exp-factorized prefix sums cancel catastrophically when the
    depth range inside one prefix is large (the difference of two huge
    near-equal prefixes must resolve an e^{-range} subtree sum), so the
    builder splits segments at a SMALL range delta (MSTConfig.max_log_range,
    default 4) and this filter iterates `carry_iters` rounds of cross-cut
    carry injection: round k restores all paths crossing <= k cuts exactly,
    and anything crossing more carries weight <= e^{-(k+1)*delta} (~6e-6 at
    k=2, delta=4). Worst-case fp32 cancellation error is ~eps * e^{2 delta}
    (~3e-4 at delta=4), so k=2 is already below the method's own noise
    floor; each extra round costs two more full Euler-prefix passes.
    """
    e_neg = jnp.exp(-f.rel_gd)
    e_pos = jnp.exp(f.rel_gd)
    is_tree_root = f.parent_node == jnp.arange(f.parent_node.shape[0])
    w2c = 1.0 - f.w_exp * f.w_exp

    # ---- up-sweep with iterated cross-cut carries ----
    t0 = e_neg * c_node

    def up_step(_, u):
        # cross-cut carries in GATHER form: node p receives w_c * U(c) from
        # each of its (<= 3; 4 at tree roots, device builder) cut children —
        # a few static gathers instead of an Sc-sized scatter-add (Sc ~ N/2
        # on textured images)
        inj = f.cut_child_w[0] * u[..., f.cut_child_idx[0]]
        for s in range(1, f.cut_child_idx.shape[0]):
            inj = inj + f.cut_child_w[s] * u[..., f.cut_child_idx[s]]
        return e_pos * _subtree_sums(t0 + e_neg * inj, f)

    u = e_pos * _subtree_sums(t0, f)
    u = jax.lax.fori_loop(0, carry_iters, up_step, u)

    # ---- down-sweep: D(p) = w_p D(par) + (1 - w_p^2) U(p) ----
    def down(seed_root):
        v = jnp.where(f.seg_root, seed_root, e_pos * w2c * u)
        return e_neg * _ancestor_sums(v, f)

    def down_step(_, d):
        d_par = jnp.take_along_axis(
            d, jnp.broadcast_to(f.parent_node, d.shape), axis=-1
        )
        seed = jnp.where(is_tree_root, u, f.w_exp * d_par + w2c * u)
        return down(seed)

    # first pass: every segment root acts as a tree root (D = U)
    d = down(u)
    return jax.lax.fori_loop(0, carry_iters, down_step, d)


def aggregation_norm_inv(
    f: ForestArrays,
    carry_iters: int = 2,
) -> jax.Array:
    """Per-node reciprocal of the tree-filtered ONES volume — the reference's
    cost_norm_factor (ComputeMSTCostNormFactor: up-sweep from 1.0 per node +
    the standard down-sweep, src/PatchMatchStereoGPU.cu:5415-5429; inverted
    once at :5919). Multiplying an aggregate by this turns the weighted
    support SUM into a weighted support MEAN. Computed once per forest."""
    ones = jnp.ones_like(f.w_exp)
    return 1.0 / tree_filter(ones, f, carry_iters)


def label_cost(
    cost_vol: jax.Array,
    a: jax.Array,
    b: jax.Array,
    c: jax.Array,
    f: ForestArrays,
    max_disp: int,
    vol_in_node_order: bool = False,
) -> jax.Array:
    """Per-node data cost of plane labels (a, b, c) given per-NODE params.

    d = x*a + y*b + c, linearly interpolated in the (H, W, D) cost volume;
    out-of-range planes cost 0.5 (ref: compute3DLabelCost,
    src/Stereo3DMST.cpp:103-117). a/b/c: (..., N) node-order arrays.

    vol_in_node_order: cost_vol's rows are already permuted to NODE order
    (parallel.mst_mesh.volume_in_node_order). Then row p of the flat
    volume belongs to node p, so the per-iteration gather reads
    CONSECUTIVE rows with a per-row column select — the local-window
    gather class — instead of permutation-random rows. The permutation
    itself costs one volume pass, amortized over every iteration x
    candidate of an optimize call.
    """
    pix = f.pixel_of_node
    x = (pix % f.width).astype(jnp.float32)
    y = (pix // f.width).astype(jnp.float32)
    d = x * a + y * b + c
    if max_disp < 2:
        # a D=1 volume has no in-range lerp pair (hi < max_disp is
        # always false) — every plane costs the out-of-range 0.5, which
        # the (1, 2)-slice gather below could not even trace
        return jnp.full(d.shape, 0.5, jnp.float32)
    d_floor = jnp.floor(d)
    lo = d_floor.astype(jnp.int32)
    hi = lo + 1
    in_range = (lo >= 0) & (hi < max_disp)
    vol_flat = cost_vol.reshape(-1, cost_vol.shape[-1])  # (HW or N, D)
    row = jnp.arange(pix.shape[0], dtype=jnp.int32) if vol_in_node_order else pix
    # ONE (1, 2)-slice gather fetches BOTH lerp endpoints per node —
    # half the gather INSTRUCTIONS of two separate adjacent-column
    # gathers for the same bytes.
    # start is clipped to D-2 so the slice stays in range; out-of-range
    # planes are overwritten with 0.5 below, exactly as before. The
    # batched candidate axes flatten into the gather's batch dim. A bf16
    # volume (MSTConfig.volume_dtype) halves the bytes — the lerp and
    # all aggregation stay f32 (costs are in [0, 0.5]: bf16's 8 mantissa
    # bits give ~2e-3 absolute cost noise, below the aggregation floor).
    start = jnp.clip(lo, 0, max_disp - 2)
    bshape = start.shape  # (..., N)
    idx = jnp.stack(
        [jnp.broadcast_to(row, bshape).reshape(-1), start.reshape(-1)],
        axis=-1,
    )
    pair = jax.lax.gather(
        vol_flat,
        idx,
        jax.lax.GatherDimensionNumbers(
            offset_dims=(1,), collapsed_slice_dims=(0,),
            start_index_map=(0, 1),
        ),
        slice_sizes=(1, 2),
        mode=jax.lax.GatherScatterMode.CLIP,
    )
    c_lo = pair[:, 0].reshape(bshape).astype(jnp.float32)
    c_hi = pair[:, 1].reshape(bshape).astype(jnp.float32)
    frac = d - d_floor
    return jnp.where(in_range, (1.0 - frac) * c_lo + frac * c_hi, 0.5)


def plane_labels_from_disparity(
    disp_img: jax.Array,
    f: ForestArrays,
    smooth_radius: int = 2,
):
    """Per-node plane labels (a, b, c) seeded from a per-pixel disparity
    image in PIXELS (e.g. SGBM's output with invalids filled).

    The image is box-smoothed (staircase/quantization noise in a WTA map
    would otherwise leak into the gradients), (a, b) are its central-
    difference gradients and c = d - a x - b y, so each node's plane
    passes through the smoothed disparity at its own pixel with the
    locally-fitted slant. Beyond the reference (which always starts from
    random planes, src/Stereo3DMST.cpp:396-430) — the seed turns the
    optimizer's long random-search phase into a short refinement phase
    (models/mst.py::mst_stereo_seeded)."""
    from .filters import box_filter

    d = jnp.asarray(disp_img, jnp.float32)
    if smooth_radius > 0:
        d = box_filter(d, smooth_radius, mode="reflect")
    b_img, a_img = jnp.gradient(d)  # d/dy, d/dx (one-sided at edges)
    pix = f.pixel_of_node
    x = (pix % f.width).astype(jnp.float32)
    y = (pix // f.width).astype(jnp.float32)
    df = d.reshape(-1)[pix]
    a = a_img.reshape(-1)[pix]
    b = b_img.reshape(-1)[pix]
    c = df - a * x - b * y
    return a, b, c


def labels_to_disparity(
    a: jax.Array, b: jax.Array, c: jax.Array, f: ForestArrays, max_disp: int
) -> jax.Array:
    """Per-pixel disparity image from node-order plane labels, normalized to
    [0, 1] like the reference (LabelToDisp, src/Stereo3DMST.cpp:189-201):
    clamp01((x*a + y*b + c) / (max_disp - 1))."""
    pix = f.pixel_of_node
    x = (pix % f.width).astype(jnp.float32)
    y = (pix // f.width).astype(jnp.float32)
    d = jnp.clip((x * a + y * b + c) / (max_disp - 1.0), 0.0, 1.0)
    img = jnp.zeros((f.height * f.width,), jnp.float32).at[pix].set(d)
    return img.reshape(f.height, f.width)


def _sample_plane(key, px, py, d_max):
    """Random plane through (px, py) with hemisphere-sampled normal
    (ref init: src/Stereo3DMST.cpp:396-430). Shapes follow px."""
    k1, k2, k3 = jax.random.split(key, 3)
    d = jax.random.uniform(k1, px.shape) * d_max
    # rejection-free remap of the reference's disc rejection sampling:
    # sample (x1, x2) uniformly in the unit disc via polar coordinates.
    r = jnp.sqrt(jax.random.uniform(k2, px.shape))
    th = jax.random.uniform(k3, px.shape) * (2.0 * jnp.pi)
    x1, x2 = r * jnp.cos(th), r * jnp.sin(th)
    s = jnp.sqrt(jnp.maximum(1.0 - x1 * x1 - x2 * x2, 0.0))
    nx, ny = 2.0 * x1 * s, 2.0 * x2 * s
    nz = jnp.sqrt(jnp.maximum(1.0 - nx * nx - ny * ny, 1e-8))
    a = -nx / nz
    b = -ny / nz
    c = (nx * px + ny * py + nz * d) / nz
    return a, b, c


def init_labels(key, f: ForestArrays, max_disp: int):
    """Random per-node plane labels (node order)."""
    n = f.pixel_of_node.shape[0]
    px = (f.pixel_of_node % f.width).astype(jnp.float32)
    py = (f.pixel_of_node // f.width).astype(jnp.float32)
    return _sample_plane(key, px, py, float(max_disp))


def refine_deltas(max_disp: int, start: float | None = None):
    """Annealed refinement schedule: max_d = Dmax/2, /2, ... > 0.1 with the
    normal delta halving alongside (ref: src/Stereo3DMST.cpp:584-625).
    Returns (deltas_d, deltas_n) float32 arrays of length n_refine.

    start: begin the ladder at this disparity delta instead of Dmax/2 —
    the (d, n) pairs stay on the reference's schedule, just entered
    further down. A run seeded from an already-good disparity map
    (plane_labels_from_disparity) has no use for Dmax/2 perturbations;
    truncating the ladder cuts the per-iteration candidate count (and so
    the dominant tree_filter bytes) proportionally."""
    deltas = []
    md = 0.5 * max_disp if start is None else float(start)
    mn = min(1.0, md / (0.5 * max_disp))
    while md > 0.1:
        deltas.append((md, mn))
        md, mn = md * 0.5, mn * 0.5
    deltas_d = jnp.asarray([d for d, _ in deltas], jnp.float32)
    deltas_n = jnp.asarray([m for _, m in deltas], jnp.float32)
    return deltas_d, deltas_n


def make_candidate_fn(
    key_i: jax.Array,
    a: jax.Array,
    b: jax.Array,
    c: jax.Array,
    f: ForestArrays,
    max_disp: int,
    max_neighbors: int,
    deltas_d: jax.Array,
    deltas_n: jax.Array,
):
    """Per-iteration candidate generator: cand(j) -> per-tree plane params
    (a, b, c), each (tmax,), for GLOBAL candidate index j.

    j < max_neighbors: one label sampled from a random pixel of a random
    neighboring tree (spatial propagation across trees,
    ref: src/Stereo3DMST.cpp:569-573). j >= max_neighbors: annealed random
    refinement level j - max_neighbors around a random node's label
    (:584-625). `j` may be a Python int (single-chip, branch const-folds)
    or a traced int32 (mesh sharding over candidates,
    parallel/mst_mesh.py) — RNG is keyed by the global j either way, so a
    candidate's value is independent of which device evaluates it.
    """
    tmax = f.tree_start.shape[0] - 1
    n_refine = deltas_d.shape[0]
    tsize = (f.tree_start[1:] - f.tree_start[:-1]).astype(jnp.float32)
    nb_count = (f.adj_start[1:] - f.adj_start[:-1]).astype(jnp.float32)
    ka, kb, kc = jax.random.split(key_i, 3)

    # base label for refinements: one random node per tree, drawn once per
    # iteration and shared by all refinement levels
    u = jax.random.uniform(kb, (tmax,))
    base_node = f.tree_start[:-1] + jnp.minimum(
        (u * jnp.maximum(tsize, 1.0)).astype(jnp.int32),
        jnp.maximum(tsize - 1.0, 0.0).astype(jnp.int32),
    )
    pa, pb, pc = a[base_node], b[base_node], c[base_node]
    px = (f.pixel_of_node[base_node] % f.width).astype(jnp.float32)
    py = (f.pixel_of_node[base_node] // f.width).astype(jnp.float32)
    nz = 1.0 / jnp.sqrt(pa * pa + pb * pb + 1.0)
    nx = -pa * nz
    ny = -pb * nz
    d0 = px * pa + py * pb + pc

    def cand(j):
        # ---- neighbor-tree branch ----
        kj = jax.random.fold_in(ka, j)
        k1, k2 = jax.random.split(kj)
        un = jax.random.uniform(k1, (tmax,))
        nb_idx = f.adj_start[:-1] + jnp.minimum(
            (un * jnp.maximum(nb_count, 1.0)).astype(jnp.int32),
            jnp.maximum(nb_count - 1.0, 0.0).astype(jnp.int32),
        )
        nb_tree = jnp.where(
            nb_count > 0,
            f.adj_list[jnp.clip(nb_idx, 0, f.adj_list.shape[0] - 1)],
            jnp.arange(tmax),
        )
        v = jax.random.uniform(k2, (tmax,))
        nts = f.tree_start[nb_tree]
        ntc = (f.tree_start[nb_tree + 1] - nts).astype(jnp.float32)
        node = nts + jnp.minimum(
            (v * ntc).astype(jnp.int32),
            jnp.maximum(ntc - 1.0, 0.0).astype(jnp.int32),
        )
        nb_a, nb_b, nb_c = a[node], b[node], c[node]

        # ---- annealed refinement branch ----
        jr = jnp.clip(j - max_neighbors, 0, max(n_refine - 1, 0))
        kr = jax.random.fold_in(kc, jr)
        r = jax.random.uniform(kr, (4, tmax), minval=-1.0, maxval=1.0)
        dd, dn = deltas_d[jr], deltas_n[jr]
        rd = d0 + r[0] * dd
        rnx = nx + r[1] * dn
        rny = ny + r[2] * dn
        rnz = nz + r[3] * dn
        inv = 1.0 / jnp.sqrt(rnx * rnx + rny * rny + rnz * rnz)
        rnx, rny = rnx * inv, rny * inv
        rnz = jnp.maximum(jnp.abs(rnz * inv), 1e-8)
        ca = -rnx / rnz
        cb = -rny / rnz
        cc = (rnx * px + rny * py + rnz * rd) / rnz
        ok = (rd >= 0.0) & (rd <= max_disp)
        # out-of-range draws fall back to the base label (no-op)
        rf_a = jnp.where(ok, ca, pa)
        rf_b = jnp.where(ok, cb, pb)
        rf_c = jnp.where(ok, cc, pc)

        is_nb = j < max_neighbors  # const-folds when j is a Python int
        return (
            jnp.where(is_nb, nb_a, rf_a),
            jnp.where(is_nb, nb_b, rf_b),
            jnp.where(is_nb, nb_c, rf_c),
        )

    return cand


@partial(
    jax.jit,
    static_argnames=(
        "cfg", "max_neighbors", "iterations", "candidate_chunk",
        "refine_start",
    ),
)
def mst_pms_optimize(
    key: jax.Array,
    cost_vol: jax.Array,
    f: ForestArrays,
    cfg: MSTConfig = MSTConfig(),
    max_neighbors: int = 8,
    iterations: int | None = None,
    init_state=None,
    candidate_chunk: int | None = None,
    refine_start: float | None = None,
):
    """The MST_PMS loop (ref: src/Stereo3DMST.cpp:546-629, 100 iterations at
    :858-889) for ALL trees in parallel.

    Per iteration, per tree: sample one label from a random pixel of each of
    up to `max_neighbors` neighboring trees (spatial propagation across
    trees) plus the annealed random-plane refinements (max_d halving from
    Dmax/2 to 0.1), evaluate each candidate with batched tree_filter
    passes, and keep the per-pixel argmin (the reference updates min cost
    per PIXEL, :173-185). Returns (a, b, c, min_cost) in node order.

    candidate_chunk bounds peak memory at production scale: candidates are
    evaluated `candidate_chunk` at a time through a lax.scan with a running
    per-pixel (cost, index) min — identical result to the one-shot batch
    (ties break to the smallest candidate index either way), with peak live
    tree_filter state (chunk, 2N) instead of (K, 2N). At 2048x1536 that is
    the difference between ~430 MB and ~100 MB per scan buffer.

    Deviations from the reference (documented): candidates are drawn from
    the iteration-start label map (the reference reads neighbor labels
    mid-update, racily, :556-574), and each tree samples at most
    `max_neighbors` of its neighbor trees per iteration instead of all.
    refine_start truncates the annealed ladder (see refine_deltas) for
    runs resumed/seeded from an already-good state.
    """
    n = f.pixel_of_node.shape[0]
    iters = cfg.iterations if iterations is None else iterations
    max_disp = cfg.max_disp
    if cfg.volume_dtype != "float32":
        cost_vol = cost_vol.astype(cfg.volume_dtype)
    # permute the volume to node order ONCE so every iteration's label_cost
    # gathers consecutive rows (local-window class) instead of
    # permutation-random ones; one volume pass amortized over
    # iterations x candidates (see label_cost docstring)
    cost_vol = cost_vol.reshape(-1, cost_vol.shape[-1])[f.pixel_of_node]

    deltas_d, deltas_n = refine_deltas(max_disp, refine_start)
    n_refine = int(deltas_d.shape[0])
    k_total = max_neighbors + n_refine

    # cost_norm_factor (ref .cu:5403): per-node reciprocal support weight,
    # computed once and applied to every aggregate before the min updates.
    # init_state's min_cost must come from a run with the same flag.
    inv_norm = (
        aggregation_norm_inv(f, cfg.carry_iters)
        if cfg.normalize_aggregation
        else None
    )

    key, k0 = jax.random.split(key)
    if init_state is None:
        a0, b0, c0 = init_labels(k0, f, max_disp)
        min0 = jnp.full((n,), jnp.inf, jnp.float32)
    else:
        # resume from a checkpointed (a, b, c, min_cost) node-order state
        # (utils/checkpoint.py) — the reference has no equivalent (SURVEY §5)
        a0, b0, c0, min0 = (jnp.asarray(x) for x in init_state)

    def iteration(carry, key_i):
        """All of this iteration's candidates (neighbor-tree samples +
        annealed refinements) are evaluated in batched tree_filter passes:
        the Euler prefix sums amortize over the candidate axis, unlike the
        reference's candidate-at-a-time tree walks."""
        a, b, c, mc = carry
        cand = make_candidate_fn(
            key_i, a, b, c, f, max_disp, max_neighbors, deltas_d, deltas_n
        )
        params = [cand(j) for j in range(k_total)]
        ka_ = jnp.stack([t[0] for t in params])  # (K, tmax)
        kb_ = jnp.stack([t[1] for t in params])
        kc_ = jnp.stack([t[2] for t in params])

        def eval_block(pa_, pb_, pc_):
            na = pa_[:, f.tree_id]  # (Kb, N)
            nb = pb_[:, f.tree_id]
            nc = pc_[:, f.tree_id]
            cn = label_cost(
                cost_vol, na, nb, nc, f, max_disp, vol_in_node_order=True
            )
            agg = tree_filter(cn, f, cfg.carry_iters)  # (Kb, N)
            return agg if inv_norm is None else agg * inv_norm

        if candidate_chunk is None or candidate_chunk >= k_total:
            agg = eval_block(ka_, kb_, kc_)
            best_k = jnp.argmin(agg, axis=0)
            best_agg = jnp.min(agg, axis=0)
        else:
            chunk = candidate_chunk
            pad = (-k_total) % chunk
            kap = jnp.pad(ka_, ((0, pad), (0, 0)))
            kbp = jnp.pad(kb_, ((0, pad), (0, 0)))
            kcp = jnp.pad(kc_, ((0, pad), (0, 0)))
            n_chunks = (k_total + pad) // chunk

            def chunk_step(carry2, ci):
                bc, bk = carry2
                j0 = ci * chunk
                sa = jax.lax.dynamic_slice_in_dim(kap, j0, chunk, 0)
                sb = jax.lax.dynamic_slice_in_dim(kbp, j0, chunk, 0)
                sc = jax.lax.dynamic_slice_in_dim(kcp, j0, chunk, 0)
                agg = eval_block(sa, sb, sc)
                live = (j0 + jnp.arange(chunk)) < k_total
                agg = jnp.where(live[:, None], agg, jnp.inf)
                lk = jnp.argmin(agg, axis=0)
                lc = jnp.min(agg, axis=0)
                better2 = lc < bc  # strict: first (smallest-j) min wins
                return (
                    jnp.where(better2, lc, bc),
                    jnp.where(better2, j0 + lk, bk),
                ), None

            (best_agg, best_k), _ = jax.lax.scan(
                chunk_step,
                (jnp.full((n,), jnp.inf, jnp.float32), jnp.zeros((n,), jnp.int32)),
                jnp.arange(n_chunks),
            )
            ka_, kb_, kc_ = kap, kbp, kcp  # best_k indexes the padded stack

        # per-pixel best over {current, candidates} (reference updates per
        # PIXEL, Stereo3DMST.cpp:173-185); winning params re-gathered from
        # the (K, tmax) stacks via (best_k, tree_id)
        better = best_agg < mc
        state = (
            jnp.where(better, ka_[best_k, f.tree_id], a),
            jnp.where(better, kb_[best_k, f.tree_id], b),
            jnp.where(better, kc_[best_k, f.tree_id], c),
            jnp.where(better, best_agg, mc),
        )
        return state, None

    keys = jax.random.split(key, iters)
    (a, b, c, mc), _ = jax.lax.scan(iteration, (a0, b0, c0, min0), keys)
    return a, b, c, mc
