"""Pure-JAX Boruvka segmentation (ops/segmentation.py)."""

import numpy as np
import jax.numpy as jnp

from stereomatch_tpu.ops.segmentation import boruvka_segment, segment_image


def test_flat_image_single_component():
    img = np.full((24, 32, 3), 100.0, np.float32)
    labels = np.asarray(segment_image(jnp.asarray(img), c=5000.0, min_size=4))
    assert len(np.unique(labels)) == 1


def test_three_regions():
    h, w = 32, 48
    img = np.zeros((h, w, 3), np.float32)
    img[:, : w // 3] = 30.0
    img[:, w // 3 : 2 * w // 3] = 130.0
    img[:, 2 * w // 3 :] = 230.0
    labels = np.asarray(segment_image(jnp.asarray(img), c=200.0, min_size=8))
    # each band maps to one dominant label, and bands differ
    l0 = labels[:, : w // 3 - 1]
    l1 = labels[:, w // 3 + 1 : 2 * w // 3 - 1]
    l2 = labels[:, 2 * w // 3 + 1 :]
    for band in (l0, l1, l2):
        vals, counts = np.unique(band, return_counts=True)
        assert counts.max() / band.size > 0.9
    assert np.median(l0) != np.median(l1) != np.median(l2)


def test_min_size_merge(rng):
    """Speckles smaller than min_size must be absorbed."""
    h, w = 24, 24
    img = np.full((h, w, 3), 50.0, np.float32)
    img[10:12, 10:12] = 250.0  # 4-pixel outlier blob
    labels = np.asarray(segment_image(jnp.asarray(img), c=100.0, min_size=16))
    assert len(np.unique(labels)) == 1  # blob merged away


def _oracle_partition_stats(wr, wd, c, min_size):
    """Sequential Felzenszwalb + small-merge oracle (same rule as
    native/treebuild.cpp), returning component sizes."""
    h = wr.shape[0]
    w = wd.shape[1]
    n = h * w
    edges = []
    for y in range(h):
        for x in range(w):
            p = y * w + x
            if x < w - 1:
                edges.append((wr[y, x], p, p + 1))
            if y < h - 1:
                edges.append((wd[y, x], p, p + w))
    edges.sort(key=lambda e: e[0])
    parent = list(range(n))
    size = [1] * n

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    thr = [c] * n
    for wgt, a, b in edges:
        ra, rb = find(a), find(b)
        if ra != rb and wgt <= thr[ra] and wgt <= thr[rb]:
            parent[rb] = ra
            size[ra] += size[rb]
            thr[ra] = wgt + c / size[ra]
    for wgt, a, b in edges:
        ra, rb = find(a), find(b)
        if ra != rb and (size[ra] < max(2, min_size) or size[rb] < max(2, min_size)):
            parent[rb] = ra
            size[ra] += size[rb]
    roots = {}
    for i in range(n):
        r = find(i)
        roots[r] = roots.get(r, 0) + 1
    return np.sort(np.asarray(list(roots.values())))


def test_boruvka_statistical_parity_with_oracle(rng):
    """Borůvka batches Felzenszwalb's threshold updates, so the partition
    differs edge-by-edge; the gate is STATISTICAL: component count within ~2x of the sequential oracle and the
    min-size rule respected. (Known family difference, documented in
    ops/segmentation.py: Kruskal's strict ascending order ratchets one
    component's threshold edge by edge and tends to grow a single giant
    component, while Borůvka's batched rounds merge more evenly — same
    algorithm family, more balanced partition.)"""
    for seed in (0, 1):
        r = np.random.default_rng(seed)
        h, w = 40, 56
        img = (r.random((h, w, 3)) * 255).astype(np.float32)
        for _ in range(2):
            img = (img + np.roll(img, 1, 0) + np.roll(img, 1, 1)) / 3
        wr = np.abs(img[:, 1:] - img[:, :-1]).sum(-1)
        wd = np.abs(img[1:] - img[:-1]).sum(-1)
        c, min_size = 400.0, 12

        oracle_sizes = _oracle_partition_stats(wr, wd, c, min_size)
        labels = np.asarray(
            boruvka_segment(jnp.asarray(wr), jnp.asarray(wd), c, min_size)
        )
        _, b_sizes = np.unique(labels, return_counts=True)
        b_sizes = np.sort(b_sizes)

        n_o, n_b = len(oracle_sizes), len(b_sizes)
        assert 0.3 * n_o <= n_b <= 2.5 * n_o + 2, (n_b, n_o)
        # min-size rule respected (allow a couple of stragglers from
        # bounded merge rounds)
        assert (b_sizes < min_size).sum() <= 2, b_sizes[:5]


def test_pyforest_fallback_matches_two_pass(rng):
    """The pure-Python fallback forest (native/pyforest.py) must satisfy
    the Forest contract: tree_filter on it reproduces the reference's
    two-pass recurrence, and optimization runs."""
    import jax.numpy as jnp2

    from stereomatch_tpu.native.pyforest import build_forest_fallback
    from stereomatch_tpu.ops.mst import forest_arrays, tree_filter
    from tests.test_mst import _reference_two_pass

    h, w = 16, 20
    img = (rng.random((h, w, 3)) * 255).astype(np.float32)
    wr = np.abs(img[:, 1:] - img[:, :-1]).sum(-1)
    wd = np.abs(img[1:] - img[:-1]).sum(-1)
    f = build_forest_fallback(wr, wd, 300.0, 4, gamma=1 / 12.0, delta=4.0)
    n = h * w
    # structural invariants
    assert sorted(f.pixel_of_node) == list(range(n))
    assert sorted(np.concatenate([f.in_pos, f.out_pos])) == list(range(2 * n))
    assert (f.in_pos < f.out_pos).all()
    assert (f.parent_node <= np.arange(n)).all()

    fa = forest_arrays(f)
    cost_node = rng.random(n).astype(np.float32) * 0.5
    got = np.asarray(tree_filter(jnp2.asarray(cost_node), fa))
    expect = _reference_two_pass(f, cost_node, 1 / 12.0)
    np.testing.assert_allclose(got, expect, rtol=1e-3, atol=1e-4)


def test_rank_tables_precomputed_matches_internal(rng):
    """boruvka_segment with a caller-supplied (rank, eid_by_rank) pair
    (the shared-sort path build_forest_device uses) is bit-identical to
    the internal-sort path."""
    import jax
    from stereomatch_tpu.ops.segmentation import boruvka_segment

    h, w = 24, 31
    img = rng.random((h, w, 3)).astype(np.float32) * 255
    wr = jnp.sum(jnp.abs(jnp.asarray(img[:, 1:]) - img[:, :-1]), -1)
    wd = jnp.sum(jnp.abs(jnp.asarray(img[1:]) - img[:-1]), -1)
    ew = jnp.concatenate([wr.reshape(-1), wd.reshape(-1)]).astype(jnp.float32)
    eid = jnp.arange(ew.shape[0], dtype=jnp.int32)
    _, eid_by_rank = jax.lax.sort((ew, eid), num_keys=2)
    rank = jnp.zeros(ew.shape[0], jnp.int32).at[eid_by_rank].set(eid)

    a = np.asarray(boruvka_segment(wr, wd, 300.0, 8))
    b = np.asarray(
        boruvka_segment(wr, wd, 300.0, 8, rank_tables=(rank, eid_by_rank))
    )
    assert (a == b).all()
