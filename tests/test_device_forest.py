"""On-device forest builder (ops/device_forest.py) vs the host builders.

Structural invariants of the ForestArrays contract, exact MST parity with
the pure-Python Kruskal oracle (unique under (weight, edge-id) keys —
including heavily tied integer weights, where the oracle's stable argsort
breaks ties by edge id exactly like the device keys), float64 parity of
tree_filter against the reference two-pass recurrence, and an end-to-end
label-optimization plane recovery. Reference counterparts:
src/Stereo3DMST.cpp:213-543 (segment + forest build).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from stereomatch_tpu.config import MSTConfig
from stereomatch_tpu.native.pyforest import forest_from_labels
from stereomatch_tpu.ops.device_forest import (
    build_forest_device,
    device_forest_arrays,
)
from stereomatch_tpu.ops.mst import (
    labels_to_disparity,
    mst_pms_optimize,
    tree_filter,
)


def _random_weights(rng, h, w, tied):
    e = h * (w - 1) + (h - 1) * w
    if tied == "flat":
        # all-zero weights: one component spanning the whole image — the
        # deepest tour/chains the Euler Wyllie ranking and ancestor
        # doubling ever see (their convergence loops must run to the full
        # round bound and still match the Kruskal oracle exactly)
        ew = np.zeros(e, np.float32)
    elif tied:
        ew = rng.integers(0, 6, e).astype(np.float32)
    else:
        ew = rng.permutation(e).astype(np.float32) * 0.03
    return ew[: h * (w - 1)].reshape(h, w - 1), ew[h * (w - 1):].reshape(h - 1, w)


def _build(wr, wd, **kw):
    h, w = wr.shape[0], wd.shape[1]
    kw.setdefault("tmax", max(64, h * w // 4))
    kw.setdefault("adj_cap", 8 * h * w)
    raw = build_forest_device(jnp.asarray(wr), jnp.asarray(wd), **kw)
    return raw, device_forest_arrays(raw, h, w, tmax=kw["tmax"])


def _undirected(pairs):
    return {(min(a, b), max(a, b)) for a, b in pairs if a != b}


@pytest.mark.parametrize("seed,tied,delta", [
    (0, False, 2.0), (1, True, 2.0), (2, True, 0.5), (3, False, 8.0),
    (4, "flat", 2.0),
])
def test_structure_and_mst_parity(seed, tied, delta):
    rng = np.random.default_rng(seed)
    h, w = 13, 18
    n = h * w
    wr, wd = _random_weights(rng, h, w, tied)
    gamma = 1.0
    raw, fa = _build(wr, wd, c=30.0, min_size=4, gamma=gamma, delta=delta)

    pix = np.asarray(fa.pixel_of_node)
    assert sorted(pix.tolist()) == list(range(n))

    # the oracle builds per-component Kruskal MSTs on the SAME partition
    labels = np.asarray(raw["labels"]).reshape(h, w)
    fo = forest_from_labels(labels, wr, wd, gamma, delta)
    par = np.asarray(fa.parent_node)
    assert _undirected(zip(pix, pix[par])) == _undirected(
        zip(fo.pixel_of_node, fo.pixel_of_node[fo.parent_node])
    )

    # parents precede children in node order (consumers rely on it)
    nonroot = par != np.arange(n)
    assert (par[nonroot] < np.arange(n)[nonroot]).all()

    # band rule bound: rel_gd in [0, delta)
    rel = np.asarray(fa.rel_gd)
    assert rel.min() >= -1e-5 and rel.max() < delta + 1e-4

    # w_exp: 0 exactly at tree roots, exp(-gamma*w) elsewhere
    we = np.asarray(fa.w_exp)
    assert (we[~nonroot] == 0.0).all()
    assert (we[nonroot] > 0.0).all() and (we[nonroot] <= 1.0).all()

    # Euler events: a permutation of [0, 2N) with proper nesting and
    # segment-contiguous blocks
    inp, outp = np.asarray(fa.in_pos), np.asarray(fa.out_pos)
    ev = np.full(2 * n, -1, np.int64)
    opn = np.zeros(2 * n, bool)
    for i in range(n):
        assert ev[inp[i]] == -1 and ev[outp[i]] == -1
        ev[inp[i]] = i
        opn[inp[i]] = True
        ev[outp[i]] = i
    stack = []
    for p in range(2 * n):
        if opn[p]:
            stack.append(ev[p])
        else:
            assert stack and stack[-1] == ev[p]
            stack.pop()
    assert not stack

    seg_root = np.asarray(fa.seg_root)
    seg_of = np.cumsum(seg_root) - 1
    starts = np.flatnonzero(seg_root)
    # each segment's events occupy exactly [2*start, 2*end)
    ends = np.append(starts[1:], n)
    for s, t in zip(starts, ends):
        evs = np.concatenate([inp[s:t], outp[s:t]])
        assert evs.min() == 2 * s and evs.max() == 2 * t - 1
    # euler_reset marks exactly the segment-opening events
    er = np.asarray(fa.euler_reset)
    assert np.flatnonzero(er).tolist() == (2 * starts).tolist()
    # within a segment the parent bracket contains the child bracket
    for i in range(n):
        if par[i] != i and seg_of[par[i]] == seg_of[i]:
            assert inp[par[i]] < inp[i] < outp[i] < outp[par[i]]

    assert np.all(np.asarray(fa.sub_end) == np.arange(n) + (outp - inp + 1) // 2)

    # tree blocks: tree_id ascending, CSR counts match
    tid = np.asarray(fa.tree_id)
    assert (np.diff(tid) >= 0).all()
    ts = np.asarray(fa.tree_start)
    tmax = len(ts) - 1
    counts = np.bincount(tid, minlength=tmax)
    assert (np.diff(ts) == counts).all()

    # inter-tree adjacency == unique cross-partition edge pairs, both
    # directions, compared via root PIXELS (tree numbering differs
    # between the builders)
    t_root_pix = {t: pix[ts[t]] for t in range(int(raw["num_trees_actual"]))}
    adj_start = np.asarray(fa.adj_start)
    adj_list = np.asarray(fa.adj_list)
    dev_pairs = set()
    for t in range(int(raw["num_trees_actual"])):
        for q in adj_list[adj_start[t]:adj_start[t + 1]]:
            dev_pairs.add((min(t, int(q)), max(t, int(q))))
    dev_pairs_pix = {(min(t_root_pix[a], t_root_pix[b]),
                      max(t_root_pix[a], t_root_pix[b])) for a, b in dev_pairs}
    ots = fo.tree_start
    o_root_pix = {t: fo.pixel_of_node[ots[t]] for t in range(fo.num_trees)}
    o_pairs_pix = set()
    for t in range(fo.num_trees):
        for q in fo.adj_list[fo.adj_start[t]:fo.adj_start[t + 1]]:
            o_pairs_pix.add((min(o_root_pix[t], o_root_pix[int(q)]),
                             max(o_root_pix[t], o_root_pix[int(q)])))
    assert dev_pairs_pix == o_pairs_pix


def _direct_two_pass(parent, w_exp, cost_node):
    """Reference recurrence (aggregateCostFromChildren/FromParent,
    src/Stereo3DMST.cpp:120-158) in float64 on the unsplit forest."""
    n = len(cost_node)
    up = cost_node.astype(np.float64).copy()
    w = w_exp.astype(np.float64)
    for i in range(n - 1, -1, -1):
        if parent[i] != i:
            up[parent[i]] += w[i] * up[i]
    down = up.copy()
    for i in range(n):
        if parent[i] != i:
            down[i] = w[i] * down[parent[i]] + (1.0 - w[i] * w[i]) * up[i]
    return down


@pytest.mark.parametrize("delta", [1.0, 4.0])
def test_tree_filter_matches_direct_recurrence(rng, delta):
    h, w = 14, 17
    wr, wd = _random_weights(np.random.default_rng(11), h, w, tied=False)
    _, fa = _build(wr, wd, c=40.0, min_size=4, gamma=0.25, delta=delta)
    cost = rng.random(h * w).astype(np.float32) * 0.5
    # paths crossing more than carry_iters cuts are dropped at weight
    # ~e^{-(k+1)*delta}; keep that below the fp32 tolerance at small delta
    k = max(3, int(np.ceil(10.0 / delta)))
    got = np.asarray(tree_filter(jnp.asarray(cost), fa, carry_iters=k))
    expect = _direct_two_pass(
        np.asarray(fa.parent_node), np.asarray(fa.w_exp), cost
    )
    np.testing.assert_allclose(got, expect, rtol=2e-3, atol=2e-4)


def test_scan_maps_match_host_construction():
    """The traced jnp scan maps equal the host numpy construction for the
    same reset vector."""
    from stereomatch_tpu.ops.device_forest import _scan_maps_jnp
    from stereomatch_tpu.ops.mst import _make_scan_maps

    rng = np.random.default_rng(5)
    reset = rng.random(700) < 0.2
    reset[0] = True
    want = _make_scan_maps(reset)
    got = _scan_maps_jnp(jnp.asarray(reset))
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_optimize_with_device_forest_recovers_plane(rng):
    h, w, d = 20, 28, 16
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    true_d = 2.0 + 0.1 * xx + 0.05 * yy
    vol = np.minimum(
        np.abs(np.arange(d, dtype=np.float32)[None, None, :] - true_d[..., None])
        * 0.15,
        0.5,
    )
    wr, wd_ = _random_weights(np.random.default_rng(3), h, w, tied=False)
    _, fa = _build(
        wr, wd_, c=50.0, min_size=8, gamma=0.5, delta=4.0, tmax=256,
        adj_cap=4096,
    )
    cfg = MSTConfig(max_disp=d, iterations=30, gamma=0.5)
    a, b, c, _ = mst_pms_optimize(
        jax.random.PRNGKey(0), jnp.asarray(vol), fa, cfg
    )
    disp = np.asarray(labels_to_disparity(a, b, c, fa, d)) * (d - 1)
    assert np.abs(disp - true_d).mean() < 0.5


def test_mst_stereo_device_backend_absolute_gt():
    """The full 3DMST pipeline with forest_backend="device" (no host work
    in the frame loop) meets the same absolute-GT gates as the host path
    (tests/test_gt_battery.py::test_mst_absolute_gt, slightly loosened:
    the Boruvka partition and band splits are the documented parallel
    relaxations of the sequential rules)."""
    from stereomatch_tpu.config import CostVolumeConfig
    from stereomatch_tpu.eval import disparity_metrics
    from stereomatch_tpu.models.mst import mst_stereo
    from stereomatch_tpu.ops.cost import adgrad_bgr_volumes
    from stereomatch_tpu.synthetic import render_scene, scene_eval_mask

    sc = render_scene(1, 240, 320, 32)
    m = scene_eval_mask(sc)
    lv, rv = adgrad_bgr_volumes(
        sc.left, sc.right, CostVolumeConfig(min_disp=0, max_disp=31)
    )
    lv, rv = np.asarray(lv), np.asarray(rv)
    s = 0.5 / max(lv.max(), rv.max())
    out = mst_stereo(
        sc.left,
        sc.right,
        lv * s,
        rv * s,
        MSTConfig(
            max_disp=32, iterations=30, min_cc_size=100, c=2000.0,
            forest_backend="device",
        ),
        seed=0,
        max_neighbors=4,
    )
    valid = np.asarray(out.left_valid) & m
    assert valid.mean() > 0.35
    mm = disparity_metrics(np.asarray(out.left_disp), sc.disp_left, valid)
    assert mm["epe"] < 1.5, mm
    assert mm["bad2"] < 0.10, mm


def test_fused_frame_matches_unfused_device_path():
    """mst_stereo_fused (the whole frame as ONE jitted program) follows
    the same RNG stream and stages as mst_stereo with
    forest_backend="device" — outputs agree up to XLA fusion-level fp
    reassociation (label argmins can flip only on fp ties)."""
    from stereomatch_tpu.models.mst import mst_stereo, mst_stereo_fused

    rng = np.random.default_rng(9)
    h, w, d = 40, 56, 16
    bgr_l = rng.random((h, w, 3)).astype(np.float32) * 255
    for _ in range(2):
        bgr_l = (bgr_l + np.roll(bgr_l, 1, 0) + np.roll(bgr_l, 1, 1)) / 3
    bgr_r = np.roll(bgr_l, -3, axis=1)
    vol_l = (rng.random((h, w, d)) * 0.5).astype(np.float32)
    vol_r = (rng.random((h, w, d)) * 0.5).astype(np.float32)
    cfg = MSTConfig(
        max_disp=d, iterations=8, min_cc_size=20, c=800.0,
        forest_backend="device",
    )
    out_u = mst_stereo(bgr_l, bgr_r, vol_l, vol_r, cfg, seed=0,
                       max_neighbors=4)
    out_f = mst_stereo_fused(bgr_l, bgr_r, vol_l, vol_r, cfg, seed=0,
                             max_neighbors=4)
    du, df = np.asarray(out_u.right_disp), np.asarray(out_f.right_disp)
    assert (np.abs(du - df) < 0.1).mean() > 0.95
    cu, cf = np.asarray(out_u.left_disp), np.asarray(out_f.left_disp)
    assert (np.abs(cu - cf) < 0.1).mean() > 0.95


def test_capacity_checks_raise():
    rng = np.random.default_rng(0)
    wr, wd = _random_weights(rng, 10, 12, tied=False)
    raw = build_forest_device(
        jnp.asarray(wr), jnp.asarray(wd), c=1e-6, min_size=1, gamma=1.0,
        delta=4.0, tmax=2, adj_cap=4,
    )
    with pytest.raises(ValueError, match="exceeds"):
        device_forest_arrays(raw, 10, 12, tmax=2)


@pytest.mark.parametrize("h,w", [(5, 7), (13, 18), (1, 9), (9, 1)])
def test_slice_endpoint_reads_match_gather(h, w):
    """_at_ea/_at_eb (grid endpoint reads as slices) must equal the
    plain x[ea]/x[eb] gathers for every grid shape — the index algebra
    the forest build's hot loops rely on."""
    from stereomatch_tpu.ops.device_forest import (
        _at_ea,
        _at_eb,
        _grid_edges_idx,
    )

    rng = np.random.default_rng(h * 100 + w)
    ea, eb = _grid_edges_idx(h, w)
    for shape in ((h * w,), (h * w, 3)):
        x = jnp.asarray(rng.random(shape).astype(np.float32))
        np.testing.assert_array_equal(
            np.asarray(_at_ea(x, h, w)), np.asarray(x[ea])
        )
        np.testing.assert_array_equal(
            np.asarray(_at_eb(x, h, w)), np.asarray(x[eb])
        )
