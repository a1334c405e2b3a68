"""Multi-device 3DMST: candidate batches sharded over the mesh.

The reference parallelizes MST_PMS with OpenMP over trees
(src/Stereo3DMST.cpp:559, schedule(dynamic)). On a device mesh the natural
shard axis is the CANDIDATE batch instead: every iteration evaluates
K = max_neighbors + n_refine independent label proposals with full-forest
tree_filter passes, so device i evaluates the strided subset
{j : j % n_devices == i} and the per-pixel winner is ONE argmin-combine
collective (pmin/psum, the same pattern as parallel/dslab.py) — perfect
load balance with no tree bucketing, and the label state stays replicated
so iterations chain with no further communication.

Exactness: candidates are RNG-keyed by their GLOBAL index j
(ops.mst.make_candidate_fn), and ties break to the smallest j both here
(lexicographic pmin) and in the single-chip argmin — so the mesh result
matches single-chip mst_pms_optimize up to fp32 rounding of the
differently-batched tree_filter (~1e-7 cost noise, which can flip
near-exact-tie winners on <<1% of pixels; tested on the 8-device CPU
mesh, tests/test_mst_mesh.py).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from .tiled import shard_map
from ..config import MSTConfig
from ..ops.mst import (
    ForestArrays,
    init_labels,
    label_cost,
    make_candidate_fn,
    refine_deltas,
    tree_filter,
)

__all__ = [
    "mst_pms_optimize_mesh",
    "make_cand_mesh",
    "make_cand_node_mesh",
    "volume_in_node_order",
    "mst_pms_optimize_mesh_sharded",
]


def make_cand_mesh(n_devices: int, devices=None) -> Mesh:
    """1-D mesh over the candidate axis."""
    import numpy as np

    devices = list(devices if devices is not None else jax.devices())
    return Mesh(np.array(devices[:n_devices]), ("cand",))


def _body(
    key,
    cost_vol,
    f: ForestArrays,
    cfg: MSTConfig,
    max_neighbors: int,
    iterations: int,
    n_dev: int,
    init_state,
    refine_start=None,
):
    n = f.pixel_of_node.shape[0]
    max_disp = cfg.max_disp
    if cfg.volume_dtype != "float32":
        cost_vol = cost_vol.astype(cfg.volume_dtype)
    deltas_d, deltas_n = refine_deltas(max_disp, refine_start)
    n_refine = int(deltas_d.shape[0])
    k_total = max_neighbors + n_refine
    kloc = -(-k_total // n_dev)  # ceil: candidate slots per device
    idx = lax.axis_index("cand")

    key, k0 = jax.random.split(key)
    if init_state is None:
        a0, b0, c0 = init_labels(k0, f, max_disp)
        min0 = jnp.full((n,), jnp.inf, jnp.float32)
    else:
        a0, b0, c0, min0 = (jnp.asarray(x) for x in init_state)

    def iteration(carry, key_i):
        a, b, c, mc = carry
        cand = make_candidate_fn(
            key_i, a, b, c, f, max_disp, max_neighbors, deltas_d, deltas_n
        )
        # strided local candidate indices j = t*n_dev + idx (traced)
        local_js = [t * n_dev + idx for t in range(kloc)]
        params = [cand(jnp.minimum(j, k_total - 1)) for j in local_js]
        pa_ = jnp.stack([t[0] for t in params])  # (kloc, tmax)
        pb_ = jnp.stack([t[1] for t in params])
        pc_ = jnp.stack([t[2] for t in params])

        na = pa_[:, f.tree_id]
        nb = pb_[:, f.tree_id]
        nc = pc_[:, f.tree_id]
        cn = label_cost(cost_vol, na, nb, nc, f, max_disp)
        agg = tree_filter(cn, f, cfg.carry_iters)  # (kloc, N)
        live = jnp.stack([j < k_total for j in local_js])
        agg = jnp.where(live[:, None], agg, jnp.inf)

        lt = jnp.argmin(agg, axis=0)  # smallest slot = smallest local j
        lc = jnp.min(agg, axis=0)
        lj = lt * n_dev + idx  # global candidate index of the local best

        # argmin-combine over the mesh, ties to the smallest global j
        # (matches single-chip argmin over the ordered K axis exactly)
        gmin = lax.pmin(lc, "cand")
        winner = lc == gmin
        gj = lax.pmin(jnp.where(winner, lj, k_total), "cand")
        mask = winner & (lj == gj)  # exactly one device per pixel
        sel = lambda arr: lax.psum(  # noqa: E731
            jnp.where(mask, arr[lt, f.tree_id], 0.0), "cand"
        )

        better = gmin < mc
        state = (
            jnp.where(better, sel(pa_), a),
            jnp.where(better, sel(pb_), b),
            jnp.where(better, sel(pc_), c),
            jnp.where(better, gmin, mc),
        )
        return state, None

    keys = jax.random.split(key, iterations)
    (a, b, c, mc), _ = jax.lax.scan(iteration, (a0, b0, c0, min0), keys)
    return a, b, c, mc


@partial(
    jax.jit,
    static_argnames=("mesh", "cfg", "max_neighbors", "iterations",
                     "refine_start"),
)
def mst_pms_optimize_mesh(
    key: jax.Array,
    cost_vol: jax.Array,
    f: ForestArrays,
    mesh: Mesh,
    cfg: MSTConfig = MSTConfig(),
    max_neighbors: int = 8,
    iterations: int | None = None,
    init_state=None,
    refine_start: float | None = None,
):
    """Multi-chip MST_PMS: same signature and RESULT as
    ops.mst.mst_pms_optimize, with each iteration's candidate evaluations
    spread over the mesh's "cand" axis. Inputs are replicated; the label
    state stays replicated (the per-iteration combine is collective).
    refine_start truncates the annealed ladder for SGBM-seeded runs
    (models/sgbm_mst.py) exactly as on the single chip."""
    iters = cfg.iterations if iterations is None else iterations
    n_dev = mesh.shape["cand"]
    out_specs = (P(), P(), P(), P())

    if init_state is None:
        # shard_map needs concrete pytrees, so the no-resume case closes
        # over None instead of passing a sentinel arg
        fn = shard_map(
            lambda k, v, fa: _body(
                k, v, fa, cfg, max_neighbors, iters, n_dev, None,
                refine_start,
            ),
            mesh=mesh,
            in_specs=(P(), P(), P()),
            out_specs=out_specs,
        )
        return fn(key, cost_vol, f)
    fn = shard_map(
        lambda k, v, fa, st: _body(
            k, v, fa, cfg, max_neighbors, iters, n_dev, st, refine_start
        ),
        mesh=mesh,
        in_specs=(P(), P(), P(), P()),
        out_specs=out_specs,
    )
    return fn(key, cost_vol, f, tuple(jnp.asarray(x) for x in init_state))


# ---------------------------------------------------------------------------
# memory-sharded variant: the cost volume itself distributed over the mesh
# ---------------------------------------------------------------------------


def make_cand_node_mesh(n_cand: int, n_node: int, devices=None) -> Mesh:
    """2-D mesh (cand, node): candidates sharded over "cand" (as in
    mst_pms_optimize_mesh) and the cost volume + label-cost gather work
    sharded over "node"."""
    import numpy as np

    devices = list(devices if devices is not None else jax.devices())
    n = n_cand * n_node
    assert n <= len(devices), (n_cand, n_node, len(devices))
    arr = np.array(devices[:n]).reshape(n_cand, n_node)
    return Mesh(arr, ("cand", "node"))


def volume_in_node_order(cost_vol, f: ForestArrays):
    """Permute an (H, W, D) cost volume into NODE order: row p holds the
    costs of node p's pixel. This is the layout that makes a contiguous
    node-block shard self-sufficient for label_cost — device j's nodes
    [j*N/n, (j+1)*N/n) gather only from its own rows, with no masked
    cross-shard lookups. One gather per frame, host- or device-side."""
    d = cost_vol.shape[-1]
    return jnp.asarray(cost_vol).reshape(-1, d)[f.pixel_of_node]


def _label_cost_node_block(vol_rows, a_loc, b_loc, c_loc, pix_loc, width, max_disp):
    """label_cost for a contiguous node block whose volume rows are local.
    vol_rows: (Nloc, D) node-order rows; a/b/c/pix_loc: (..., Nloc)."""
    x = (pix_loc % width).astype(jnp.float32)
    y = (pix_loc // width).astype(jnp.float32)
    d = x * a_loc + y * b_loc + c_loc
    d_floor = jnp.floor(d)
    lo = d_floor.astype(jnp.int32)
    hi = lo + 1
    in_range = (lo >= 0) & (hi < max_disp)
    lo_c = jnp.clip(lo, 0, max_disp - 1)
    hi_c = jnp.clip(hi, 0, max_disp - 1)
    rows = jnp.arange(vol_rows.shape[0])
    c_lo = vol_rows[rows, lo_c].astype(jnp.float32)
    c_hi = vol_rows[rows, hi_c].astype(jnp.float32)
    frac = d - d_floor
    return jnp.where(in_range, (1.0 - frac) * c_lo + frac * c_hi, 0.5)


def _body_sharded(
    key,
    vol_node,
    f: ForestArrays,
    cfg: MSTConfig,
    max_neighbors: int,
    iterations: int,
    n_cand: int,
    n_node: int,
    init_state,
    refine_start=None,
):
    n = f.pixel_of_node.shape[0]
    assert n % n_node == 0, (n, n_node)
    n_loc = n // n_node
    max_disp = cfg.max_disp
    deltas_d, deltas_n = refine_deltas(max_disp, refine_start)
    n_refine = int(deltas_d.shape[0])
    k_total = max_neighbors + n_refine
    kloc = -(-k_total // n_cand)
    idx_c = lax.axis_index("cand")
    idx_n = lax.axis_index("node")
    node0 = idx_n * n_loc
    pix_loc = lax.dynamic_slice_in_dim(f.pixel_of_node, node0, n_loc)
    tid_loc = lax.dynamic_slice_in_dim(f.tree_id, node0, n_loc)
    if cfg.volume_dtype != "float32":
        vol_node = vol_node.astype(cfg.volume_dtype)

    key, k0 = jax.random.split(key)
    if init_state is None:
        a0, b0, c0 = init_labels(k0, f, max_disp)
        min0 = jnp.full((n,), jnp.inf, jnp.float32)
    else:
        a0, b0, c0, min0 = (jnp.asarray(x) for x in init_state)
    # the scan carry is device-varying over "node" (its values flow through
    # the all_gather'ed costs), so mark the invariant initial state as such
    a0, b0, c0, min0 = (
        jax.lax.pvary(x, ("node",)) for x in (a0, b0, c0, min0)
    )

    inv_norm = None
    if cfg.normalize_aggregation:
        from ..ops.mst import aggregation_norm_inv

        inv_norm = aggregation_norm_inv(f, cfg.carry_iters)

    def iteration(carry, key_i):
        a, b, c, mc = carry
        cand = make_candidate_fn(
            key_i, a, b, c, f, max_disp, max_neighbors, deltas_d, deltas_n
        )
        local_js = [t * n_cand + idx_c for t in range(kloc)]
        params = [cand(jnp.minimum(j, k_total - 1)) for j in local_js]
        pa_ = jnp.stack([t[0] for t in params])  # (kloc, tmax)
        pb_ = jnp.stack([t[1] for t in params])
        pc_ = jnp.stack([t[2] for t in params])

        # label costs: each node-shard device evaluates ITS node block
        # against ITS local volume rows, then one all_gather along "node"
        # rebuilds the full (kloc, N) per-node costs for the tree filter
        cn_loc = _label_cost_node_block(
            vol_node,
            pa_[:, tid_loc],
            pb_[:, tid_loc],
            pc_[:, tid_loc],
            pix_loc,
            f.width,
            max_disp,
        )  # (kloc, Nloc)
        cn = lax.all_gather(cn_loc, "node", axis=1, tiled=True)  # (kloc, N)
        agg = tree_filter(cn, f, cfg.carry_iters)
        if inv_norm is not None:
            agg = agg * inv_norm
        live = jnp.stack([j < k_total for j in local_js])
        agg = jnp.where(live[:, None], agg, jnp.inf)

        lt = jnp.argmin(agg, axis=0)
        lc = jnp.min(agg, axis=0)
        lj = lt * n_cand + idx_c

        gmin = lax.pmin(lc, "cand")
        winner = lc == gmin
        gj = lax.pmin(jnp.where(winner, lj, k_total), "cand")
        mask = winner & (lj == gj)
        sel = lambda arr: lax.psum(  # noqa: E731
            jnp.where(mask, arr[lt, f.tree_id], 0.0), "cand"
        )

        better = gmin < mc
        state = (
            jnp.where(better, sel(pa_), a),
            jnp.where(better, sel(pb_), b),
            jnp.where(better, sel(pc_), c),
            jnp.where(better, gmin, mc),
        )
        return state, None

    keys = jax.random.split(key, iterations)
    (a, b, c, mc), _ = jax.lax.scan(iteration, (a0, b0, c0, min0), keys)
    # values are identical on every "node" member (they flow from the
    # all_gather'ed costs); one pmin makes that replication provable to
    # shard_map's rep checker so the outputs can carry P() specs
    return tuple(jax.lax.pmin(x, "node") for x in (a, b, c, mc))


@partial(
    jax.jit,
    static_argnames=("mesh", "cfg", "max_neighbors", "iterations",
                     "refine_start"),
)
def mst_pms_optimize_mesh_sharded(
    key: jax.Array,
    vol_node: jax.Array,
    f: ForestArrays,
    mesh: Mesh,
    cfg: MSTConfig = MSTConfig(),
    max_neighbors: int = 8,
    iterations: int | None = None,
    init_state=None,
    refine_start: float | None = None,
):
    """Memory-sharded multi-device MST_PMS (mst_pms_optimize_mesh scales
    compute, not memory). The cost volume — the dominant tensor
    (3.2 GB f32 at 2048x1536x256) — lives sharded across the "node" axis
    in NODE order (volume_in_node_order), so each device holds N/n_node
    rows and label_cost gathers stay entirely shard-local; one ICI
    all_gather of the (kloc, N) per-node costs per candidate chunk feeds
    the (cheap, scan-based) tree filter, and candidates shard over "cand"
    exactly as in mst_pms_optimize_mesh. Same RNG keying by global
    candidate index -> single-chip parity up to fp rounding
    (tests/test_mst_mesh.py)."""
    iters = cfg.iterations if iterations is None else iterations
    n_cand = mesh.shape["cand"]
    n_node = mesh.shape["node"]
    out_specs = (P(), P(), P(), P())
    vol_spec = P("node", None)

    if init_state is None:
        fn = shard_map(
            lambda k, v, fa: _body_sharded(
                k, v, fa, cfg, max_neighbors, iters, n_cand, n_node, None,
                refine_start,
            ),
            mesh=mesh,
            in_specs=(P(), vol_spec, P()),
            out_specs=out_specs,
        )
        return fn(key, vol_node, f)
    fn = shard_map(
        lambda k, v, fa, st: _body_sharded(
            k, v, fa, cfg, max_neighbors, iters, n_cand, n_node, st,
            refine_start,
        ),
        mesh=mesh,
        in_specs=(P(), vol_spec, P(), P()),
        out_specs=out_specs,
    )
    return fn(key, vol_node, f, tuple(jnp.asarray(x) for x in init_state))
