"""3DMST backend: native forest builder vs a pure-Python Felzenszwalb
oracle, and the Euler-tour tree filter vs the reference's two-pass
recurrence (src/Stereo3DMST.cpp:120-158) run directly on the built forest."""

import numpy as np
import jax.numpy as jnp
import pytest

from stereomatch_tpu.native import build_forest, color_edge_weights
from stereomatch_tpu.ops.mst import (
    _make_scan_maps,
    _segmented_cumsum_mm,
    forest_arrays,
    label_cost,
    labels_to_disparity,
    mst_pms_optimize,
    segmented_cumsum_reference,
    segmented_cumsum_tolerance,
    tree_filter,
)
from stereomatch_tpu.config import MSTConfig


# ---------------------------------------------------------------------------
# oracle: Felzenszwalb + small merge, pure python
# ---------------------------------------------------------------------------


class _DSU:
    def __init__(self, n):
        self.p = list(range(n))
        self.size = [1] * n
        self.rank = [0] * n

    def find(self, x):
        while self.p[x] != x:
            self.p[x] = self.p[self.p[x]]
            x = self.p[x]
        return x

    def join(self, a, b):
        if self.rank[a] < self.rank[b]:
            a, b = b, a
        self.p[b] = a
        self.size[a] += self.size[b]
        if self.rank[a] == self.rank[b]:
            self.rank[a] += 1
        return a


def _oracle_segment(wr, wd, c, min_size):
    h, w = wr.shape[0], wd.shape[1]
    n = h * w
    edges = []
    for y in range(h):
        for x in range(w):
            p = y * w + x
            if x < w - 1:
                edges.append((wr[y, x], p, p + 1))
            if y < h - 1:
                edges.append((wd[y, x], p, p + w))
    order = sorted(range(len(edges)), key=lambda i: edges[i][0])
    dsu = _DSU(n)
    thr = [c] * n
    tree_edges = []
    for i in order:
        wgt, a, b = edges[i]
        ra, rb = dsu.find(a), dsu.find(b)
        if ra != rb and wgt <= thr[ra] and wgt <= thr[rb]:
            r = dsu.join(ra, rb)
            thr[r] = wgt + c / dsu.size[r]
            tree_edges.append((a, b, wgt))
    for i in order:
        wgt, a, b = edges[i]
        ra, rb = dsu.find(a), dsu.find(b)
        if ra != rb and (dsu.size[ra] < max(2, min_size) or dsu.size[rb] < max(2, min_size)):
            dsu.join(ra, rb)
            tree_edges.append((a, b, wgt))
    comp = [dsu.find(i) for i in range(n)]
    return comp, tree_edges


def test_builder_matches_oracle_components(rng):
    h, w = 12, 16
    img = (rng.random((h, w, 3)) * 255).astype(np.float32)
    wr, wd = color_edge_weights(img)
    c, min_size = 100.0, 4
    f = build_forest(wr, wd, c, min_size, gamma=1 / 12.0, delta=40.0)
    comp, tree_edges = _oracle_segment(wr, wd, c, min_size)

    # same partition: map each pixel to its component via tree_id
    tid = np.zeros(h * w, np.int32)
    tid[f.pixel_of_node] = f.tree_id
    # the partitions must be identical (not just same count)
    import collections

    by_comp = collections.defaultdict(set)
    for i, r in enumerate(comp):
        by_comp[r].add(i)
    by_tree = collections.defaultdict(set)
    for i, t in enumerate(tid):
        by_tree[t].add(i)
    assert sorted(map(frozenset, by_comp.values())) == sorted(
        map(frozenset, by_tree.values())
    )
    # forest has n - num_trees edges
    n_root = int((f.parent_node == np.arange(h * w)).sum())
    assert n_root == f.num_trees == len(by_comp)
    assert len(tree_edges) == h * w - f.num_trees


def test_builder_invariants(rng):
    h, w = 20, 24
    img = (rng.random((h, w, 3)) * 255).astype(np.float32)
    wr, wd = color_edge_weights(img)
    f = build_forest(wr, wd, 500.0, 8, gamma=1 / 12.0, delta=1.5)
    n = h * w
    # node order is a permutation; in/out positions a valid Euler structure
    assert sorted(f.pixel_of_node) == list(range(n))
    assert sorted(np.concatenate([f.in_pos, f.out_pos])) == list(range(2 * n))
    assert (f.in_pos < f.out_pos).all()
    assert (f.rel_gd <= 1.5 + 1e-6).all()
    # parents precede children in node order (except tree/segment roots
    # whose parent is the cut node, still earlier by construction)
    assert (f.parent_node <= np.arange(n)).all()
    # segments: one root per segment, roots have rel_gd == 0
    assert int(f.seg_root_mask().sum()) == f.num_segments
    assert (f.rel_gd[f.seg_root_mask()] == 0).all()
    # tree_start consistent with tree_id
    for t in range(f.num_trees):
        seg = f.tree_id[f.tree_start[t] : f.tree_start[t + 1]]
        assert (seg == t).all()


def _reference_two_pass(f, cost_node, gamma_):
    """Direct re-derivation of aggregateCostFromChildren/FromParent on the
    ORIGINAL (unsplit) forest, reading structure from the Forest arrays."""
    n = len(cost_node)
    # rebuild full-tree parent/weight in node order; undo segment splits:
    # parent_node already points across cuts; w_exp has exp(-gamma*w).
    parent = f.parent_node
    w = f.w_exp.astype(np.float64)
    agg = cost_node.astype(np.float64).copy()
    # children lists
    order = np.argsort(-np.arange(n))  # reverse node order = leaves first
    # leaf->root: nodes in reverse node order (parents always earlier)
    up = agg.copy()
    for i in range(n - 1, -1, -1):
        if parent[i] != i:
            up[parent[i]] += w[i] * up[i]
    # root->leaf
    down = up.copy()
    for i in range(n):
        if parent[i] != i:
            down[i] = w[i] * down[parent[i]] + (1.0 - w[i] * w[i]) * up[i]
    return down


@pytest.mark.parametrize(
    "m,mean_seg,batch,lo",
    [
        (1000, 7, (), -0.3),       # short segments, non-multiple length, no batch
        (4096, 900, (3,), -0.3),   # segments spanning many 256-blocks
        (700, 40, (13,), -0.3),    # wide batch
        (256, 256, (2, 2), -0.3),  # exactly one block, nested batch dims
        (2000, 23, (2,), -0.5),    # zero-mean values: cancelling prefixes
    ],
)
def test_segmented_cumsum_matches_float64_oracle(rng, m, mean_seg, batch, lo):
    """The blocked triangular-matmul scan against a per-segment float64
    numpy cumsum, within the error bound its docstring derives."""
    reset = rng.random(m) < 1.0 / mean_seg
    reset[0] = True
    x = (rng.random(batch + (m,)) + lo).astype(np.float32)
    got = np.asarray(_segmented_cumsum_mm(jnp.asarray(x), _make_scan_maps(reset)))
    want = segmented_cumsum_reference(x, reset)
    assert got.shape == x.shape
    err = np.abs(got - want)
    assert (err <= segmented_cumsum_tolerance(x, reset)).all(), err.max()


def test_tree_filter_matches_reference_recurrence(rng):
    h, w = 16, 20
    img = (rng.random((h, w, 3)) * 255).astype(np.float32)
    wr, wd = color_edge_weights(img)
    # small deltas force many segment splits, exercising the carry rounds
    for delta in (1.0, 4.0, 8.0):
        f = build_forest(wr, wd, 300.0, 4, gamma=1 / 12.0, delta=delta)
        fa = forest_arrays(f)
        cost_node = rng.random(h * w).astype(np.float32) * 0.5
        got = np.asarray(tree_filter(jnp.asarray(cost_node), fa))
        expect = _reference_two_pass(f, cost_node, 1 / 12.0)
        np.testing.assert_allclose(got, expect, rtol=1e-3, atol=1e-4)


def test_tree_filter_batched(rng):
    h, w = 8, 10
    img = (rng.random((h, w, 3)) * 255).astype(np.float32)
    wr, wd = color_edge_weights(img)
    f = build_forest(wr, wd, 300.0, 4, gamma=1 / 12.0, delta=4.0)
    fa = forest_arrays(f)
    costs = rng.random((3, h * w)).astype(np.float32)
    got = np.asarray(tree_filter(jnp.asarray(costs), fa))
    for k in range(3):
        np.testing.assert_allclose(
            got[k], _reference_two_pass(f, costs[k], 1 / 12.0), rtol=2e-4, atol=2e-5
        )


def test_norm_factor_matches_reference_recurrence(rng):
    """aggregation_norm_inv == 1 / (reference ComputeMSTCostNormFactor):
    the norm up-sweep (aggregateCostFromChildrenNormFactor,
    src/PatchMatchStereoGPU.cu:5333-5351: +1.0 per node, += w * child) plus
    the standard down-sweep IS the plain tree filter applied to ones."""
    from stereomatch_tpu.ops.mst import aggregation_norm_inv

    h, w = 14, 18
    img = (rng.random((h, w, 3)) * 255).astype(np.float32)
    wr, wd = color_edge_weights(img)
    for delta in (1.5, 4.0):
        f = build_forest(wr, wd, 300.0, 4, gamma=1 / 12.0, delta=delta)
        fa = forest_arrays(f)
        got = np.asarray(aggregation_norm_inv(fa))
        expect = 1.0 / _reference_two_pass(f, np.ones(h * w, np.float32), 1 / 12.0)
        np.testing.assert_allclose(got, expect, rtol=1e-3, atol=1e-5)
        # every support weight >= the node's own 1.0 contribution
        assert (got <= 1.0 + 1e-5).all()


def test_normalized_aggregation_label_invariance(rng):
    """cost_norm_factor is a per-PIXEL positive scale applied to every
    candidate's aggregate AND the stored min (.cu:5403), so pure label
    selection must be invariant — the trajectories coincide and the
    returned min_cost is exactly the scaled one. This is the honest
    characterization of the reference feature (its real effect is on
    downstream consumers of min_cost, e.g. the AL coupling .cu:7247)."""
    import dataclasses

    import jax

    from stereomatch_tpu.ops.mst import aggregation_norm_inv

    h, w, d = 16, 20, 10
    img = (rng.random((h, w, 3)) * 80 + 60).astype(np.float32)
    wr, wd = color_edge_weights(img)
    f = build_forest(wr, wd, 400.0, 8, gamma=1 / 12.0, delta=4.0)
    fa = forest_arrays(f)
    vol = (rng.random((h, w, d)) * 0.5).astype(np.float32)
    cfg = MSTConfig(max_disp=d, iterations=12)
    a1, b1, c1, m1 = mst_pms_optimize(
        jax.random.PRNGKey(3), jnp.asarray(vol), fa, cfg, max_neighbors=2,
        iterations=12,
    )
    cfg_n = dataclasses.replace(cfg, normalize_aggregation=True)
    a2, b2, c2, m2 = mst_pms_optimize(
        jax.random.PRNGKey(3), jnp.asarray(vol), fa, cfg_n, max_neighbors=2,
        iterations=12,
    )
    np.testing.assert_allclose(np.asarray(a1), np.asarray(a2), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(c1), np.asarray(c2), rtol=1e-4, atol=1e-4)
    inv = np.asarray(aggregation_norm_inv(fa))
    np.testing.assert_allclose(
        np.asarray(m2), np.asarray(m1) * inv, rtol=2e-3, atol=1e-5
    )


def test_label_cost_lerp(rng):
    h, w, d = 6, 8, 10
    img = (rng.random((h, w, 3)) * 255).astype(np.float32)
    wr, wd = color_edge_weights(img)
    f = build_forest(wr, wd, 300.0, 4, gamma=1 / 12.0, delta=40.0)
    fa = forest_arrays(f)
    vol = rng.random((h, w, d)).astype(np.float32) * 0.5
    n = h * w
    a = (rng.random(n) * 0.1 - 0.05).astype(np.float32)
    b = (rng.random(n) * 0.1 - 0.05).astype(np.float32)
    c = (rng.random(n) * d).astype(np.float32)
    got = np.asarray(
        label_cost(jnp.asarray(vol), jnp.asarray(a), jnp.asarray(b), jnp.asarray(c), fa, d)
    )
    for node in range(n):
        pix = f.pixel_of_node[node]
        x, y = pix % w, pix // w
        dv = x * a[node] + y * b[node] + c[node]
        lo, hi = int(np.floor(dv)), int(np.floor(dv)) + 1
        if hi >= d or lo < 0:
            expect = 0.5
        else:
            frac = dv - lo
            expect = (1 - frac) * vol[y, x, lo] + frac * vol[y, x, hi]
        np.testing.assert_allclose(got[node], expect, rtol=1e-5, atol=1e-6)


def test_mst_optimize_recovers_slanted_plane(rng):
    """Cost volume whose minimum follows a slanted plane d = 0.15x + 3:
    the plane-label optimizer must recover the slope, not just a
    fronto-parallel fit."""
    import jax

    h, w, d = 24, 40, 12
    img = np.full((h, w, 3), 128, np.float32)
    wr, wd = color_edge_weights(img)
    f = build_forest(wr, wd, 5000.0, 200, gamma=1 / 12.0, delta=4.0)
    fa = forest_arrays(f)
    xs = np.arange(w, dtype=np.float32)[None, :]
    d_true = 0.15 * xs + 3.0 + np.zeros((h, 1), np.float32)
    ds = np.arange(d, dtype=np.float32)[None, None, :]
    vol = np.minimum(np.abs(ds - d_true[..., None]) * 0.2, 0.5).astype(np.float32)
    cfg = MSTConfig(max_disp=d, iterations=80)
    a, b, c, _ = mst_pms_optimize(
        jax.random.PRNGKey(2), jnp.asarray(vol), fa, cfg, max_neighbors=2,
        iterations=80,
    )
    disp = np.asarray(labels_to_disparity(a, b, c, fa, d)) * (d - 1.0)
    err = np.abs(disp - d_true)
    assert err.mean() < 0.5, err.mean()


def test_mst_optimize_resume_checkpoint(rng):
    """Optimization resumed from a checkpoint must not regress min_cost and
    keeps improving (utils/checkpoint.py round-trip)."""
    import jax

    from stereomatch_tpu.utils.checkpoint import load_state, save_state

    h, w, d = 16, 20, 8
    img = np.full((h, w, 3), 128, np.float32)
    wr, wd = color_edge_weights(img)
    fa = forest_arrays(build_forest(wr, wd, 5000.0, 200, gamma=1 / 12.0, delta=4.0))
    vol = np.full((h, w, d), 0.5, np.float32)
    vol[:, :, 4] = 0.0
    cfg = MSTConfig(max_disp=d, iterations=10)
    a, b, c, mc = mst_pms_optimize(
        jax.random.PRNGKey(0), jnp.asarray(vol), fa, cfg, max_neighbors=2,
        iterations=10,
    )
    import tempfile, os

    path = os.path.join(tempfile.mkdtemp(), "mst_ckpt.npz")
    save_state(path, a=a, b=b, c=c, min_cost=mc)
    st = load_state(path)
    a2, b2, c2, mc2 = mst_pms_optimize(
        jax.random.PRNGKey(1), jnp.asarray(vol), fa, cfg, max_neighbors=2,
        iterations=10,
        init_state=(st["a"], st["b"], st["c"], st["min_cost"]),
    )
    assert (np.asarray(mc2) <= np.asarray(mc) + 1e-6).all()


def test_mst_optimize_recovers_plane(rng):
    """Cost volume with a clean fronto-parallel minimum at d=5: the
    optimizer must converge to disparity 5 everywhere."""
    h, w, d = 24, 32, 12
    img = np.full((h, w, 3), 128, np.float32)  # one tree
    wr, wd = color_edge_weights(img)
    f = build_forest(wr, wd, 5000.0, 200, gamma=1 / 12.0, delta=40.0)
    assert f.num_trees == 1
    fa = forest_arrays(f)
    vol = np.full((h, w, d), 0.5, np.float32)
    vol[:, :, 5] = 0.0
    import jax

    cfg = MSTConfig(max_disp=d, iterations=60)
    a, b, c, _ = mst_pms_optimize(
        jax.random.PRNGKey(0), jnp.asarray(vol), fa, cfg, max_neighbors=2,
        iterations=60,
    )
    disp = np.asarray(labels_to_disparity(a, b, c, fa, d)) * (d - 1.0)
    assert np.abs(disp - 5.0).mean() < 0.5, np.abs(disp - 5.0).mean()


def test_mst_coarse_to_fine_converges(rng):
    """Coarse-to-fine (models.mst_stereo_c2f): labels optimized at 1/2
    scale, upsampled as (a, b, k*c), refined briefly at full scale — must
    recover the slanted-plane-with-step scene to sub-pixel accuracy with
    only 1/4 of the full-scale iterations."""
    import jax

    from stereomatch_tpu.models.mst import mst_stereo_c2f

    h, w, d = 48, 80, 16
    xs = np.arange(w, dtype=np.float32)[None, :]
    d_true = 0.1 * xs + 3.0 + np.zeros((h, 1), np.float32)
    d_true[:, w // 2 :] += 4.0
    ds = np.arange(d, dtype=np.float32)[None, None, :]
    vol = np.minimum(np.abs(ds - d_true[..., None]) * 0.15, 0.5).astype(np.float32)
    vol += rng.random((h, w, d)).astype(np.float32) * 0.1
    img = np.full((h, w, 3), 100.0, np.float32)
    img[:, w // 2 :] = 180.0

    cfg = MSTConfig(max_disp=d, iterations=40, min_cc_size=50, c=2000.0)
    out = mst_stereo_c2f(
        img, img, vol, vol, cfg, seed=0, k=2,
        coarse_iterations=30, fine_iterations=10, max_neighbors=4,
    )
    inner = np.s_[4:-4, 4:-4]
    err = np.abs(np.asarray(out.right_disp) - d_true)[inner]
    assert (err > 1.0).mean() < 0.02, (err > 1.0).mean()
    assert err.mean() < 0.5, err.mean()


@pytest.mark.parametrize("prior", ["TV", "2TGV", "NL2TGV"])
def test_mst_smoothness_prior_surface(rng, prior):
    """The reference's smoothness-prior string surface
    ("NL2TGV"/"2TGV"/"TV"/"NONE", .cu:6819) selects a LIVE refiner here:
    output stays finite, in range, and no rougher than unrefined."""
    import dataclasses

    from stereomatch_tpu.models.mst import mst_stereo

    h, w, d = 24, 32, 8
    img = np.full((h, w, 3), 128, np.float32)
    vol = np.full((h, w, d), 0.5, np.float32)
    vol[:, :, 4] = 0.0
    vol += rng.random((h, w, d)).astype(np.float32) * 0.05
    cfg = MSTConfig(max_disp=d, iterations=15, smoothness_prior=prior,
                    smoothness_iters=20)
    out = mst_stereo(img, img, vol, vol, cfg, seed=0, max_neighbors=2)
    dr = np.asarray(out.right_disp)
    assert np.isfinite(dr).all()
    assert dr.min() >= -0.01 and dr.max() <= d - 0.99
    base = mst_stereo(
        img, img, vol, vol, dataclasses.replace(cfg, smoothness_prior="NONE"),
        seed=0, max_neighbors=2,
    )
    tv = lambda x: np.abs(np.diff(x, axis=0)).mean() + np.abs(np.diff(x, axis=1)).mean()  # noqa: E731
    # second-order priors (2TGV/NL2TGV) favor piecewise-LINEAR solutions,
    # so plain first-difference TV need not strictly decrease — allow 10%
    assert tv(dr) <= tv(np.asarray(base.right_disp)) * 1.1 + 1e-4


def test_mst_bf16_volume_matches_f32(rng):
    """MSTConfig.volume_dtype="bfloat16" (halved gather bytes in
    label_cost): label costs within bf16 quantization of f32, and the
    slanted-plane recovery stays sub-0.5px — the accuracy gate for the
    bench's bf16 bytes/iteration claim."""
    import dataclasses

    import jax

    h, w, d = 24, 40, 12
    img = np.full((h, w, 3), 128, np.float32)
    wr, wd = color_edge_weights(img)
    fa = forest_arrays(build_forest(wr, wd, 5000.0, 200, gamma=1 / 12.0, delta=4.0))
    vol = (rng.random((h, w, d)) * 0.5).astype(np.float32)
    n = h * w
    a = (rng.random(n) * 0.1 - 0.05).astype(np.float32)
    b = (rng.random(n) * 0.1 - 0.05).astype(np.float32)
    c = (rng.random(n) * d).astype(np.float32)
    c32 = np.asarray(label_cost(jnp.asarray(vol), jnp.asarray(a), jnp.asarray(b),
                                jnp.asarray(c), fa, d))
    c16 = np.asarray(label_cost(jnp.asarray(vol).astype(jnp.bfloat16),
                                jnp.asarray(a), jnp.asarray(b), jnp.asarray(c), fa, d))
    assert np.abs(c32 - c16).max() < 3e-3  # bf16 eps on [0, 0.5] costs

    xs = np.arange(w, dtype=np.float32)[None, :]
    d_true = 0.15 * xs + 3.0 + np.zeros((h, 1), np.float32)
    ds = np.arange(d, dtype=np.float32)[None, None, :]
    vol2 = np.minimum(np.abs(ds - d_true[..., None]) * 0.2, 0.5).astype(np.float32)
    cfg = MSTConfig(max_disp=d, iterations=60, volume_dtype="bfloat16")
    a, b, c, _ = mst_pms_optimize(
        jax.random.PRNGKey(2), jnp.asarray(vol2), fa, cfg, max_neighbors=2,
        iterations=60,
    )
    disp = np.asarray(labels_to_disparity(a, b, c, fa, d)) * (d - 1.0)
    assert np.abs(disp - d_true).mean() < 0.5
