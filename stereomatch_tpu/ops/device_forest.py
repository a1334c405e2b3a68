"""Fully on-device 3DMST forest construction: partition -> MST -> Euler.

The production pipeline builds the segment forest on the HOST
(native/treebuild.cpp — sequential Felzenszwalb + per-component Kruskal +
DFS numbering, 0.9-2 s per view at 2048x1536; apps/stream.py hides it with
lookahead threads). This module removes the host from the loop entirely:
the same ForestArrays contract that ops/mst.py consumes is produced by
static-shape XLA ops, so segmentation, forest construction and the
MST_PMS label loop can run as ONE jitted program on the chip.

Stage map (reference counterparts in src/Stereo3DMST.cpp):

1. partition — ops.segmentation.boruvka_segment (parallel Felzenszwalb
   family; ref :213-233 uses the sequential sorted-edge loop).
2. per-component MST — Boruvka rounds restricted to within-component
   edges (ref :434-446 runs per-component Boost Kruskal). Edge keys are
   (weight, edge-id) lexicographic, so the MST is UNIQUE even with tied
   uint8 color-diff weights; every cluster hooks every round (2-cycles
   broken toward the smaller root), giving <= ceil(log2 N) rounds.
3. rooted Euler tour — arcs in fixed R->D->L->U circular order around
   each pixel; ONE integer Wyllie list-ranking gives tour positions;
   an arc is a "down" (discovery) arc iff it precedes its reverse, which
   yields parents; node depths then come from ancestor pointer-doubling
   (log2 N int/f32 gathers — no float scan over millions of cancelling
   +-w tour terms).
4. segment split — BAND rule: cut node v iff floor(gd(v)/delta) !=
   floor(gd(parent)/delta), gd = gamma-weighted root depth. One parallel
   pass, and it guarantees the same invariant as the reference's greedy
   top-down rule (rel_gd <= delta within every segment, the fp32 range
   bound the exp-factorized tree filter needs) while cutting at most 2x
   as often. The greedy rule itself is a sequential scan along every
   root-leaf path (each cut depends on the running value) — the band
   quantization is its natural parallel relaxation. Deviation documented
   in PARITY.md; tree_filter output is split-invariant up to the carry
   tolerance, so accuracy is unchanged.
5. node order — 2-key lax.sort by (segment discovery preorder, tree
   preorder): segments become contiguous blocks, each in per-segment DFS
   preorder (restriction of a DFS preorder to a connected subtree is a
   DFS preorder of it), trees major — exactly the treebuild.cpp layout.
   Euler in/out events follow in closed form from within-segment index,
   subtree size and segment depth (no second list ranking).

Everything is int32/f32; composite sort keys are avoided (jax runs
with 32-bit types by default) in favor of 2-key variadic sorts and a vectorized
lexicographic binary search.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .mst import ForestArrays, SegScanMaps
from .segmentation import (
    _at_ea,
    _at_eb,
    _edge_rank_tables,
    _pointer_jump_conv as _compress_conv,
    boruvka_segment,
)

__all__ = ["build_forest_device", "device_forest_arrays"]

_SCAN_BLOCK = 256  # must match ops.mst._SCAN_BLOCK


def _ceil_log2(n: int) -> int:
    return max(1, int(np.ceil(np.log2(max(n, 2)))))


# _compress_conv (pointer-jump-to-fixpoint) is segmentation's
# _pointer_jump_conv — one shared implementation; see its docstring.


# ---------------------------------------------------------------------------
# stage 2: per-component minimum spanning forest (Boruvka, unique keys)
# ---------------------------------------------------------------------------


def _grid_edges_idx(h: int, w: int):
    """Flat endpoints of the 4-neighbor grid edges, right edges first
    (ids [0, h*(w-1))), then down edges — the same edge-id convention as
    the incidence table below. Built from iota (NOT numpy constants:
    multi-MB literals blow up remote compiles, CLAUDE.md)."""
    ir = jnp.arange(h * (w - 1), dtype=jnp.int32)
    a_r = (ir // (w - 1)) * w + ir % (w - 1)
    idn = jnp.arange((h - 1) * w, dtype=jnp.int32)
    ea = jnp.concatenate([a_r, idn])
    eb = jnp.concatenate([a_r + 1, idn + w])
    return ea, eb


# _at_ea / _at_eb (grid endpoint reads as slices) are shared from
# ops.segmentation — property-tested vs the plain gathers in
# tests/test_device_forest.py.


def _component_mst(lab, ea, eb, ew, n: int, rank_tables=None, hw=None):
    """Boruvka minimum spanning forest of each label component.

    Returns (E,) bool: edge is in the forest. Keys are (weight, edge id)
    lexicographic — every cluster's minimum outgoing key is unique, so
    the result is THE forest Kruskal-with-stable-ties would build and the
    per-round chosen-edge set is acyclic. All clusters hook every round
    (the classic 2-cycle between mutual minima is broken toward the
    smaller root), so cluster count at least halves per round and the
    convergence-tested round/compress loops stop at ceil(log2 N) rounds
    worst case with no explicit bound needed.
    """
    e = ea.shape[0]
    big = jnp.int32(2**30)
    me = jnp.arange(n, dtype=jnp.int32)
    # per-edge endpoint reads are SLICES when the grid shape is known
    # (_at_ea/_at_eb) — the edge index arrays are data-independent, and
    # the compiler does not recognize the gather-by-affine-iota pattern
    at_a = (lambda x: _at_ea(x, *hw)) if hw else (lambda x: x[ea])
    at_b = (lambda x: _at_eb(x, *hw)) if hw else (lambda x: x[eb])
    same = at_a(lab) == at_b(lab)
    # edge RANKS by (weight, edge id): the per-cluster minimum key is
    # ONE int32 scatter-min over ranks per round (see _edge_rank_tables)
    if rank_tables is None:
        rank, eid_by_rank = _edge_rank_tables(ew)
    else:
        rank, eid_by_rank = rank_tables

    def do_round(_, state):
        parent, tree = state
        ra = at_a(parent)
        rb = at_b(parent)
        ok = same & (ra != rb)
        rv = jnp.where(ok, rank, big)
        best_r = jnp.full(n, big, jnp.int32).at[ra].min(rv).at[rb].min(rv)
        has = best_r < big
        be = eid_by_rank[jnp.clip(best_r, 0, e - 1)]
        # endpoint roots of the chosen edge from the per-edge root
        # arrays already materialized this round: one packed row gather
        # at be instead of four chained N-gathers
        epack = jnp.stack([ra, rb], axis=1)
        grb = epack[be]
        ra_e = grb[:, 0]
        rb_e = grb[:, 1]
        other = jnp.where(ra_e == me, rb_e, ra_e)
        # mutual pair = the two roots chose each other; only the larger
        # hooks (breaks the 2-cycle), everyone else hooks unconditionally
        mutual = other[jnp.clip(other, 0, n - 1)] == me
        hooked = has & (parent == me) & ~(mutual & (me < other))
        # the hooking root's chosen edge is a cluster-minimum outgoing
        # edge -> in the MST by the cut property; exactly one mark per merge
        tree = tree.at[jnp.where(hooked, be, e)].set(True, mode="drop")
        p = jnp.where(hooked, other, parent)
        p = _compress_conv(p)
        return p, tree, jnp.any(hooked)

    def cond(state):
        return state[2]

    def body(state):
        p, tree, _ = state
        return do_round(None, (p, tree))

    parent0 = me
    tree0 = jnp.zeros(e, bool)
    # converge instead of running a blind log2(N) round bound: cluster
    # count at least halves per round, and a round with zero hooks is
    # the fixpoint (the final extra round only discovers convergence)
    _, tree, _ = jax.lax.while_loop(
        cond, body, (parent0, tree0, jnp.bool_(True))
    )
    return tree


# ---------------------------------------------------------------------------
# stage 3: rooted Euler tour of every tree
# ---------------------------------------------------------------------------


def _incidence(h: int, w: int, er: int):
    """(4, N) int32 OUTGOING-arc id per pixel along its incident edge in
    circular R, D, L, U slot order (-1 where off-grid; arc = edge for
    a->b, edge + E for b->a). The incident-EDGE table this used to also
    return is dead since the padded-slice inc_live rewrite. iota, not
    numpy constants (multi-MB literals blow up remote compiles,
    CLAUDE.md)."""
    n = h * w
    e = er + (h - 1) * w
    p = jnp.arange(n, dtype=jnp.int32)
    ys, xs = p // w, p % w
    right = ys * (w - 1) + xs
    down = er + p
    left = right - 1
    up = down - w
    neg = jnp.full((n,), -1, jnp.int32)
    return jnp.stack([
        jnp.where(xs < w - 1, right, neg),  # pixel is endpoint a
        jnp.where(ys < h - 1, down, neg),  # endpoint a
        jnp.where(xs > 0, left + e, neg),  # endpoint b
        jnp.where(ys > 0, up + e, neg),  # endpoint b
    ])


def _euler_tour(tree_edge, lab, ea, eb, h: int, w: int):
    """Tour positions + parents + subtree sizes from the forest edge set.

    Returns a dict of per-pixel arrays: parent (self at roots), parent
    edge weight index, preorder within tree, subtree size, plus per-pixel
    tree size. Tour = one Wyllie ranking over 2E arcs.
    """
    n = h * w
    er = h * (w - 1)
    e = ea.shape[0]
    na = 2 * e
    out_arc = _incidence(h, w, er)
    aid = jnp.arange(na, dtype=jnp.int32)
    edge_of = jnp.where(aid < e, aid, aid - e)
    fwd = aid < e
    # arc tables are CONCATENATIONS (arc = edge for a->b, edge + E for
    # b->a), not gathers — ea[edge_of] etc. would be arc-sized gathers
    # with affine indices the compiler may not recognize as copies
    tail = jnp.concatenate([ea, eb])
    head = jnp.concatenate([eb, ea])
    live = jnp.concatenate([tree_edge, tree_edge])

    # slot of the arc's edge at its head pixel: forward arcs enter b
    # (slot L for right edges, U for down), backward arcs enter a (R / D)
    is_right = edge_of < er
    in_slot = jnp.where(
        fwd,
        jnp.where(is_right, 2, 3),
        jnp.where(is_right, 0, 1),
    ).astype(jnp.int32)

    # live-incident lookup per (slot, pixel): the incidence table is
    # grid-structured, so each slot is a PADDED SLICE of the tree-edge
    # halves (False off-grid) — four E-sized gathers become reshapes
    ter = tree_edge[:er].reshape(h, w - 1)
    ted = tree_edge[er:].reshape(h - 1, w)
    inc_live = jnp.stack([
        jnp.pad(ter, ((0, 0), (0, 1))).reshape(-1),  # R: off at x=w-1
        jnp.pad(ted, ((0, 1), (0, 0))).reshape(-1),  # D: off at y=h-1
        jnp.pad(ter, ((0, 0), (1, 0))).reshape(-1),  # L: off at x=0
        jnp.pad(ted, ((1, 0), (0, 0))).reshape(-1),  # U: off at y=0
    ])  # (4, N)

    # successor: next live outgoing slot after in_slot (cyclic); the
    # reverse arc's own slot is always live, so a hit is guaranteed.
    # The per-pixel slot table is PACKED into (N, 4) rows ("live
    # outgoing arc or -1") so the whole construction costs ONE arc-sized
    # row gather at head — the naive form paid 8 arc-sized gathers
    # (live flag + out arc, 4 slots each); the column select afterwards
    # works on already-gathered rows (elementwise, stream-class)
    slot_arc = jnp.where(inc_live, out_arc, -1).T  # (N, 4) int32
    # head = concat(eb, ea) is grid-structured -> endpoint SLICES, not
    # an arc-sized row gather
    arcs4 = jnp.concatenate(
        [_at_eb(slot_arc, h, w), _at_ea(slot_arc, h, w)]
    )  # (na, 4)
    succ = jnp.full(na, -1, jnp.int32)
    taken = jnp.zeros(na, bool)
    for off in range(1, 5):
        k = (in_slot + off) % 4
        cand = jnp.take_along_axis(arcs4, k[:, None], axis=1)[:, 0]
        ok = ~taken & (cand >= 0)
        succ = jnp.where(ok, cand, succ)
        taken = taken | ok

    # root = the component label pixel; its first live outgoing arc
    # starts the tour, so the arc whose successor would re-enter it ends
    first_out = jnp.full(n, -1, jnp.int32)
    for k in (3, 2, 1, 0):  # reversed: first live slot wins
        first_out = jnp.where(inc_live[k], out_arc[k], first_out)
    # tail = concat(ea, eb) is grid-structured -> endpoint slices
    root_of_arc = jnp.concatenate([_at_ea(lab, h, w), _at_eb(lab, h, w)])
    start_arc = first_out[root_of_arc]
    nxt = jnp.where(live & (succ != start_arc), succ, -1)
    nxt = jnp.where(live, nxt, -1)

    # Wyllie suffix count -> tour position (ints, exact). Two round-5
    # traffic cuts, both bit-identical:
    #  - COMPACTION: only tree arcs are live (<= 2N-2 of the 2E ~ 4N
    #    grid arcs — half the array is dead weight), so the ranking runs
    #    on live arcs renumbered by a cumsum; 3 stream/scatter passes of
    #    setup+teardown halve every doubling round's gather bytes.
    #  - CONVERGENCE (same pattern as _component_mst / _compress_conv):
    #    done when every successor pointer is -1, after ceil(log2(longest
    #    tour)) rounds — the blind schedule paid the full log2 bound for
    #    the worst case of one tree spanning the whole image.
    m = 2 * n  # static live-arc capacity (2*(N-1) max over any forest)
    cpos = jnp.cumsum(live.astype(jnp.int32)) - 1  # live-arc index
    tgt = jnp.where(live, cpos, m)
    has_nxt = live & (nxt >= 0)
    cnxt = jnp.full(m, -1, jnp.int32).at[tgt].set(
        jnp.where(has_nxt, cpos[jnp.clip(nxt, 0, na - 1)], -1),
        mode="drop",
    )
    ccnt = jnp.zeros(m, jnp.int32).at[tgt].set(1, mode="drop")

    def wyllie_cond(state):
        vp, k = state
        return (k < _ceil_log2(m) + 1) & jnp.any(vp[:, 1] >= 0)

    def wyllie(state):
        # (value, successor) ride ONE packed row gather per doubling
        # round instead of two separate m-sized gathers at the same index
        vp, k = state
        p = vp[:, 1]
        has = p >= 0
        row = vp[jnp.clip(p, 0, m - 1)]
        v = vp[:, 0] + jnp.where(has, row[:, 0], 0)
        p = jnp.where(has, row[:, 1], -1)
        return jnp.stack([v, p], axis=1), k + 1

    vp, _ = jax.lax.while_loop(
        wyllie_cond, wyllie,
        (jnp.stack([ccnt, cnxt], axis=1), jnp.int32(0)),
    )
    cnt = jnp.where(live, vp[jnp.clip(cpos, 0, m - 1), 0], 0)
    tsize = jnp.zeros(n, jnp.int32).at[lab].add(1)  # per ROOT pixel
    arcs_tree = 2 * (tsize[root_of_arc] - 1)
    pos = jnp.where(live, arcs_tree - cnt, -1)  # 0-based within tree

    # down arc = precedes its reverse = the discovery arc of its head.
    # rev(a) = a +- E is a pure half-rotation, so pos[rev] is two slices
    # (stream), never an arc-sized gather
    pos_rev = jnp.concatenate([pos[e:], pos[:e]])
    down = live & (pos < pos_rev)

    parent = jnp.arange(n, dtype=jnp.int32)
    parent = parent.at[jnp.where(down, head, n)].set(
        jnp.where(down, tail, 0), mode="drop"
    )

    # subtree size: the arcs in [pos(down), pos(rev)] span exactly
    # 2*tsub positions, so tsub = (pos(rev) - pos(down) + 1) / 2
    tsub_arc = (pos_rev - pos + 1) // 2
    tsub = tsize[lab]  # roots: whole tree
    tsub = tsub.at[jnp.where(down, head, n)].set(
        jnp.where(down, tsub_arc, 0), mode="drop"
    )

    return {
        "edge_of": edge_of,
        "down": down,
        "head": head,
        "pos": pos,
        "parent": parent,
        "tsub": tsub,
        "tsize_root": tsize,
    }


def _ancestor_doubling(parent, vals, iters: int):
    """Sum each value along the ancestor chain (parent self-loops at
    roots terminate accumulation since their contribution is 0).

    Runs to CONVERGENCE (all doubled ancestors are roots) instead of the
    blind log2(N) bound `iters`: after k rounds anc is the 2^k-th
    ancestor, so the loop stops at ceil(log2(max tree depth)) rounds —
    typically ~8-10 on real segmentations vs the 21-round worst case.
    anc2 == anc everywhere implies every anc is already a root, which
    implies that round added only the roots' zero contributions and the
    accumulation is complete.

    All carried arrays PLUS the ancestor pointer ride ONE packed f32 row
    gather per round (pointers are exact in f32 mantissas below 2^24
    nodes — guarded by boruvka_segment upstream; int32 values must fit
    f32 exactly too, true for the depth counts this module sums)."""
    del iters  # documented worst-case bound; convergence governs
    if parent.shape[0] > (1 << 24):  # static check; enforced where the
        # f32 packing actually corrupts, not just at the public entry
        raise ValueError(
            f"_ancestor_doubling: {parent.shape[0]} nodes exceeds 2^24 — "
            "packed f32 rows cannot hold the ancestor pointers exactly"
        )
    k = len(vals)
    cols = [v.astype(jnp.float32) for v in vals] + [
        parent.astype(jnp.float32)
    ]
    pk0 = jnp.stack(cols, axis=1)  # (N, k+1)

    def body(state):
        pk, _ = state
        anc = pk[:, k].astype(jnp.int32)
        row = pk[anc]
        anc2 = row[:, k]
        vs = pk[:, :k] + row[:, :k]
        done = jnp.all(anc2 == pk[:, k])
        return jnp.concatenate([vs, anc2[:, None]], axis=1), done

    def cond(state):
        return ~state[1]

    pk, _ = jax.lax.while_loop(cond, body, (pk0, jnp.bool_(False)))
    out = tuple(
        pk[:, i].astype(vals[i].dtype) for i in range(k)
    )
    return out


def _lex_lower_bound(k1, k2, q1, q2, iters: int):
    """First index i with (k1[i], k2[i]) >= (q1, q2) lexicographically.
    k1/k2 sorted lexicographically ascending; vectorized binary search.
    The two key columns are packed into (N, 2) rows so every search step
    costs ONE N-sized row gather instead of two."""
    n = k1.shape[0]
    kp = jnp.stack([k1, k2], axis=1)  # (N, 2) int32
    lo = jnp.zeros_like(q1)
    hi = jnp.full_like(q1, n)

    def body(_, lh):
        lo, hi = lh
        active = lo < hi
        mid = (lo + hi) // 2
        row = kp[jnp.clip(mid, 0, n - 1)]
        a1 = row[:, 0]
        a2 = row[:, 1]
        lt = (a1 < q1) | ((a1 == q1) & (a2 < q2))
        lo = jnp.where(active & lt, mid + 1, lo)
        hi = jnp.where(active & ~lt, mid, hi)
        return lo, hi

    lo, _ = jax.lax.fori_loop(0, iters, body, (lo, hi))
    return lo


# ---------------------------------------------------------------------------
# scan-map construction (jnp port of ops.mst._make_scan_maps — same
# outputs, traced)
# ---------------------------------------------------------------------------


def _scan_maps_jnp(reset: jax.Array, block: int = _SCAN_BLOCK) -> SegScanMaps:
    m = reset.shape[0]
    pad = (-m) % block
    mp = m + pad
    r = jnp.concatenate([reset, jnp.ones((pad,), bool)]) if pad else reset
    idx = jnp.arange(mp, dtype=jnp.int32)
    lrs = jax.lax.cummax(jnp.where(r, idx, -1))
    blk_start = (idx // block) * block
    has_corr = lrs - 1 >= blk_start
    corr_idx = jnp.where(has_corr, lrs - 1, 0).astype(jnp.int32)
    needs_carry = lrs < blk_start
    nb = mp // block
    lrs_end = lrs.reshape(nb, block)[:, -1]
    bs = blk_start.reshape(nb, block)[:, 0]
    blk_reset = lrs_end >= bs
    blk_has_corr = lrs_end > bs
    blk_corr_idx = jnp.where(blk_has_corr, lrs_end - 1, 0).astype(jnp.int32)
    return SegScanMaps(
        corr_idx=corr_idx,
        has_corr=has_corr,
        needs_carry=needs_carry,
        blk_reset=blk_reset,
        blk_has_corr=blk_has_corr,
        blk_corr_idx=blk_corr_idx,
    )


# ---------------------------------------------------------------------------
# the full builder
# ---------------------------------------------------------------------------


@partial(
    jax.jit,
    static_argnames=(
        "c", "min_size", "gamma", "delta", "tmax", "adj_cap",
        "seg_rounds", "seg_merge_rounds",
    ),
)
def build_forest_device(
    wr: jax.Array,
    wd: jax.Array,
    c: float = 5000.0,
    min_size: int = 200,
    gamma: float = 1.0 / 12.0,
    delta: float = 4.0,
    tmax: int = 4096,
    adj_cap: int = 32768,
    seg_rounds: int = 12,
    seg_merge_rounds: int = 6,
):
    """Segment + build the MST forest fully on device (stages 1-5 above).

    wr: (H, W-1) right-edge weights, wd: (H-1, W) down-edge weights —
    the same L1 color diffs the host builder takes (native.build_forest).
    tmax: static tree-capacity bound (trees beyond it would be folded
    into slot tmax-1 — pick tmax >= the component count; see
    models.mst.build_view_forest for the bucketing heuristic). adj_cap:
    static bound on the directed inter-tree adjacency list.

    Returns the raw per-node/per-tree arrays as a dict; wrap with
    device_forest_arrays (outside jit) to get a ForestArrays.
    """
    h = wr.shape[0]
    w = wd.shape[1]
    n = h * w
    logn = _ceil_log2(n) + 1

    ea, eb = _grid_edges_idx(h, w)
    ew = jnp.concatenate([wr.reshape(-1), wd.reshape(-1)]).astype(jnp.float32)
    # ONE (weight, edge id) sort shared by segmentation and the
    # component MST (identical edge layout: right edges row-major, then
    # down) — each used to pay its own
    rank, eid_by_rank = _edge_rank_tables(ew)

    lab = boruvka_segment(
        wr, wd, c, min_size, rounds=seg_rounds,
        merge_rounds=seg_merge_rounds, rank_tables=(rank, eid_by_rank),
    ).reshape(-1)
    lab = _compress_conv(lab)  # idempotent component root pixel ids

    tree_edge = _component_mst(
        lab, ea, eb, ew, n, rank_tables=(rank, eid_by_rank), hw=(h, w)
    )

    t = _euler_tour(tree_edge, lab, ea, eb, h, w)
    parent, tsub = t["parent"], t["tsub"]
    down, head, pos, edge_of = t["down"], t["head"], t["pos"], t["edge_of"]
    tsize_root = t["tsize_root"]

    # parent edge weight per pixel (0 at roots)
    pw = jnp.zeros(n, jnp.float32)
    pw = pw.at[jnp.where(down, head, n)].set(
        jnp.where(down, ew[edge_of], 0.0), mode="drop"
    )

    # depths by ancestor doubling (no float scan over the tour)
    d_int, gd = _ancestor_doubling(
        parent,
        (jnp.where(parent == jnp.arange(n), 0, 1).astype(jnp.int32),
         jnp.float32(gamma) * pw),
        logn,
    )

    # preorder within tree: # down arcs at tour positions <= discovery =
    # (pos + 1 + depth) / 2; roots have pre 0
    disc_pos = jnp.full(n, -1, jnp.int32)
    disc_pos = disc_pos.at[jnp.where(down, head, n)].set(
        jnp.where(down, pos, 0), mode="drop"
    )
    is_root = parent == jnp.arange(n, dtype=jnp.int32)
    pre = jnp.where(is_root, 0, (disc_pos + 1 + d_int) // 2)

    # tree ranks in ascending-root-pixel order + per-tree node offsets
    root_mask = is_root
    tree_rank_at_root = jnp.cumsum(root_mask.astype(jnp.int32)) - 1
    node_off_at_root = jnp.cumsum(
        jnp.where(root_mask, tsize_root, 0)
    ) - jnp.where(root_mask, tsize_root, 0)
    tree_rank = tree_rank_at_root[lab]  # per pixel
    pre_g = node_off_at_root[lab] + pre  # global preorder, tree-major

    # stage 4: band segment split
    band = jnp.floor(gd * jnp.float32(1.0 / delta)).astype(jnp.int32)
    segroot_mask = is_root | (band != band[parent])
    sr = jnp.where(segroot_mask, jnp.arange(n, dtype=jnp.int32), parent)
    sr = _compress_conv(sr)  # nearest segment-root ancestor-or-self
    rel_gd = gd - gd[sr]
    seg_depth = d_int - d_int[sr]  # # strict in-segment ancestors
    seg_key = pre_g[sr]  # segment discovery order, tree-major

    # stage 5: node order = lexsort by (segment, preorder)
    pixels = jnp.arange(n, dtype=jnp.int32)
    seg_s, pre_s, pix_s = jax.lax.sort(
        (seg_key, pre_g, pixels), num_keys=2
    )
    node_of_pixel = jnp.zeros(n, jnp.int32).at[pix_s].set(pixels)
    # per-node gathers of per-pixel quantities
    parent_node = jnp.where(
        is_root[pix_s], jnp.arange(n, dtype=jnp.int32),
        node_of_pixel[parent[pix_s]],
    )
    w_exp = jnp.where(
        is_root[pix_s], 0.0, jnp.exp(-jnp.float32(gamma) * pw[pix_s])
    )
    seg_first = jnp.concatenate(
        [jnp.ones((1,), bool), seg_s[1:] != seg_s[:-1]]
    )
    seg_start = jax.lax.cummax(jnp.where(seg_first, pixels, 0))
    # within-segment subtree size via lexicographic binary search over the
    # sorted (segment, preorder) keys
    s_end = _lex_lower_bound(
        seg_s, pre_s, seg_s, pre_s + tsub[pix_s], logn
    )
    s_sz = s_end - pixels
    lidx = pixels - seg_start
    a_str = seg_depth[pix_s]
    in_pos = 2 * seg_start + 2 * lidx - a_str
    out_pos = in_pos + 2 * s_sz - 1

    tree_id_n = tree_rank[pix_s]
    counts = jnp.zeros(tmax, jnp.int32).at[
        jnp.clip(tree_id_n, 0, tmax - 1)
    ].add(1)
    tree_start = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(counts)]
    )

    # inter-tree adjacency: cross-partition image edges -> unique
    # (lo, hi) tree-rank pairs -> directed CSR (ref treebuild.cpp:264-294)
    ta = _at_ea(tree_rank, h, w)
    tb = _at_eb(tree_rank, h, w)
    crossing = ta != tb
    lo = jnp.where(crossing, jnp.minimum(ta, tb), tmax)
    hi = jnp.where(crossing, jnp.maximum(ta, tb), tmax)
    lo_s, hi_s = jax.lax.sort((lo, hi), num_keys=2)
    uniq = (
        jnp.concatenate(
            [jnp.ones((1,), bool),
             (lo_s[1:] != lo_s[:-1]) | (hi_s[1:] != hi_s[:-1])]
        )
        & (lo_s < tmax)
    )
    deg = (
        jnp.zeros(tmax + 1, jnp.int32)
        .at[jnp.where(uniq, lo_s, tmax)].add(1)
        .at[jnp.where(uniq, hi_s, tmax)].add(1)
    )[:tmax]
    adj_start = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(deg)]
    )
    src = jnp.concatenate([
        jnp.where(uniq, lo_s, tmax), jnp.where(uniq, hi_s, tmax)
    ])
    dst = jnp.concatenate([
        jnp.where(uniq, hi_s, tmax), jnp.where(uniq, lo_s, tmax)
    ])
    src_s, dst_s = jax.lax.sort((src, dst), num_keys=2)
    # dead entries (src = tmax) sort to the tail; live ones land in CSR
    # order. Clamp values so a stray gather past adj_total stays in range.
    adj_list = jnp.minimum(dst_s[:adj_cap], tmax - 1)
    adj_total = adj_start[tmax]

    # cut-child gather maps (4 slots: a tree root can have 4 cut children)
    sc = seg_first & ~is_root[pix_s]  # segment roots that are not tree roots
    ckey = jnp.where(sc, parent_node, n)
    ck_s, cn_s = jax.lax.sort((ckey, pixels), num_keys=2)
    run_first = jnp.concatenate(
        [jnp.ones((1,), bool), ck_s[1:] != ck_s[:-1]]
    )
    run_start = jax.lax.cummax(jnp.where(run_first, pixels, 0))
    slot = pixels - run_start
    okc = (ck_s < n) & (slot < 4)
    cut_child_idx = jnp.tile(jnp.arange(n, dtype=jnp.int32), (4, 1))
    cut_child_w = jnp.zeros((4, n), jnp.float32)
    cut_child_idx = cut_child_idx.at[
        jnp.where(okc, slot, 4), jnp.where(okc, ck_s, 0)
    ].set(cn_s, mode="drop")
    cut_child_w = cut_child_w.at[
        jnp.where(okc, slot, 4), jnp.where(okc, ck_s, 0)
    ].set(w_exp[cn_s], mode="drop")

    euler_reset = jnp.zeros(2 * n, bool).at[
        jnp.where(seg_first, in_pos, 2 * n)
    ].set(True, mode="drop")
    euler_src = jnp.zeros(2 * n, jnp.int32).at[in_pos].set(pixels)
    euler_src = euler_src.at[out_pos].set(pixels)
    euler_is_in = jnp.zeros(2 * n, bool).at[in_pos].set(True)

    num_trees_actual = jnp.sum(root_mask.astype(jnp.int32))

    return {
        "pixel_of_node": pix_s,
        "parent_node": parent_node,
        "w_exp": w_exp,
        "rel_gd": rel_gd[pix_s],
        "in_pos": in_pos,
        "out_pos": out_pos,
        "tree_id": tree_id_n,
        "seg_root": seg_first,
        "euler_reset": euler_reset,
        "euler_src": euler_src,
        "euler_is_in": euler_is_in,
        "cut_child_idx": cut_child_idx,
        "cut_child_w": cut_child_w,
        "tree_start": tree_start,
        "adj_start": adj_start,
        "adj_list": adj_list,
        "sub_end": pixels + s_sz,
        "nscan": _scan_maps_jnp(seg_first),
        "escan": _scan_maps_jnp(euler_reset),
        "num_trees_actual": num_trees_actual,
        "adj_total": adj_total,
        "labels": lab,
    }


def device_forest_arrays(
    raw: dict, height: int, width: int, tmax: int, check: bool = True
) -> ForestArrays:
    """Assemble build_forest_device output into the ForestArrays contract
    (static num_trees = the tmax capacity; empty tail trees have zero
    size and are never sampled into nodes).

    check=True pulls two scalars to the host to verify the static
    capacities were not exceeded (one tiny sync per frame)."""
    if check:
        nt = int(raw["num_trees_actual"])
        if nt > tmax:
            raise ValueError(
                f"component count {nt} exceeds tmax={tmax}; rebuild with a "
                "larger tree capacity"
            )
        at = int(raw["adj_total"])
        if at > raw["adj_list"].shape[0]:
            raise ValueError(
                f"inter-tree adjacency {at} exceeds adj_cap="
                f"{raw['adj_list'].shape[0]}"
            )
    return ForestArrays(
        pixel_of_node=raw["pixel_of_node"],
        parent_node=raw["parent_node"],
        w_exp=raw["w_exp"],
        rel_gd=raw["rel_gd"],
        in_pos=raw["in_pos"],
        out_pos=raw["out_pos"],
        tree_id=raw["tree_id"],
        seg_root=raw["seg_root"],
        euler_reset=raw["euler_reset"],
        euler_src=raw["euler_src"],
        euler_is_in=raw["euler_is_in"],
        cut_child_idx=raw["cut_child_idx"],
        cut_child_w=raw["cut_child_w"],
        tree_start=raw["tree_start"],
        adj_start=raw["adj_start"],
        adj_list=raw["adj_list"],
        sub_end=raw["sub_end"],
        nscan=raw["nscan"],
        escan=raw["escan"],
        num_trees=tmax,
        height=height,
        width=width,
    )
