"""SPMD layer: tiled pipeline == monolithic pipeline on a virtual 8-device
CPU mesh (SURVEY.md §4: the standard JAX way to test mesh logic host-side)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from stereomatch_tpu.config import (
    CostVolumeConfig,
    CostVolumePipelineConfig,
    DenoiseConfig,
    GuidedFilterConfig,
)
from stereomatch_tpu.models import cost_volume_stereo
from stereomatch_tpu.parallel import (
    halo_exchange_rows,
    make_mesh,
    tiled_cost_volume_stereo,
)


@pytest.fixture(scope="module")
def mesh():
    # the virtual CPU devices (conftest sets
    # xla_force_host_platform_device_count=8)
    try:
        cpus = jax.devices("cpu")
    except RuntimeError:
        cpus = []
    if len(cpus) < 4:
        pytest.skip("needs the virtual 8-device CPU mesh")
    return make_mesh(n_tile=4, devices=cpus[:4])


def _cpu(x):
    return jax.device_put(x, jax.devices("cpu")[0])


def _assert_disp_close(a, b, atol=0.02, tie_frac=0.01):
    """Disparity maps equal up to subpixel fp noise, allowing a tiny
    fraction of WTA tie flips (argmin over fp-reassociated costs)."""
    diff = np.abs(a - b)
    flipped = diff > atol
    assert flipped.mean() <= tie_frac, (
        f"{flipped.mean():.4f} of pixels differ by >{atol} "
        f"(max {diff.max():.3f})"
    )


def test_halo_exchange_rows(mesh):
    from stereomatch_tpu.parallel.tiled import shard_map
    from jax.sharding import PartitionSpec as P

    x = np.arange(32.0, dtype=np.float32).reshape(16, 2)

    fn = shard_map(
        lambda b: halo_exchange_rows(b, 2, "tile"),
        mesh=mesh,
        in_specs=P("tile"),
        out_specs=P("tile"),
    )
    out = np.asarray(fn(x))  # (16 + 4*2*2) rows... each tile emits Hs+4
    out = out.reshape(4, 8, 2)
    # tile 1's block must be [rows 2-3 (halo), rows 4-7, rows 8-9 (halo)]
    np.testing.assert_array_equal(out[1, 2:6], np.asarray(x[4:8]))
    np.testing.assert_array_equal(out[1, :2], np.asarray(x[2:4]))
    np.testing.assert_array_equal(out[1, 6:], np.asarray(x[8:10]))
    # global edges zero-filled
    np.testing.assert_array_equal(out[0, :2], 0.0)
    np.testing.assert_array_equal(out[3, 6:], 0.0)


def test_tiled_equals_monolithic(mesh, rng):
    h, w, d = 64, 48, 16
    cfg = CostVolumePipelineConfig(
        volume=CostVolumeConfig(min_disp=0, max_disp=d - 1),
        guided=GuidedFilterConfig(radius=3, slab=8),
        denoise=DenoiseConfig(iterations=15),
    )
    left = (rng.random((h, w, 3)) * 255).astype(np.float32)
    right = (rng.random((h, w, 3)) * 255).astype(np.float32)

    mono = cost_volume_stereo(_cpu(left), _cpu(right), cfg)
    fn = tiled_cost_volume_stereo(mesh, cfg)
    tl, tr = fn(left, right)

    # box-filter cumsums run over different extents (tile block vs whole
    # image), so costs differ at fp32 rounding level; the parabola-subpixel
    # division amplifies that into ~1e-3 disparity noise, and a near-exact
    # WTA tie can legitimately flip to a different disparity.
    _assert_disp_close(np.asarray(tl), np.asarray(mono.left_disp))
    _assert_disp_close(np.asarray(tr), np.asarray(mono.right_disp))


def test_sgbm_batch_mesh_matches_single(mesh, rng):
    """Frame-data-parallel SGBM over the mesh == per-frame single runs."""
    from stereomatch_tpu.config import SGBMConfig
    from stereomatch_tpu.ops.sgbm import sgbm_disparity
    from stereomatch_tpu.parallel import make_mesh, sgbm_batch_mesh

    cpus = jax.devices("cpu")
    m = make_mesh(n_tile=1, n_frame=4, devices=cpus[:4])
    cfg = SGBMConfig(min_disp=0, num_disp=16, block_size=5)
    b, h, w = 4, 32, 64
    base = (rng.random((b, h, w + 6)) * 255).astype(np.float32)
    left, right = base[..., :w], base[..., 4 : 4 + w]
    fn = sgbm_batch_mesh(m, cfg)
    disp, valid = fn(left, right)
    disp, valid = np.asarray(disp), np.asarray(valid)
    for k in range(b):
        ref = sgbm_disparity(_cpu(left[k]), _cpu(right[k]), cfg)
        np.testing.assert_allclose(disp[k], np.asarray(ref.disparity), atol=1e-5)
        np.testing.assert_array_equal(valid[k], np.asarray(ref.valid))


def test_tiled_no_denoise_close(mesh, rng):
    """Without the iterative denoise, tiled WTA matches monolithic up to
    fp32 reassociation noise through the subpixel fit."""
    h, w, d = 32, 40, 8
    cfg = CostVolumePipelineConfig(
        volume=CostVolumeConfig(min_disp=0, max_disp=d - 1),
        guided=GuidedFilterConfig(radius=2, slab=8),
    )
    left = (rng.random((h, w, 3)) * 255).astype(np.float32)
    right = (rng.random((h, w, 3)) * 255).astype(np.float32)
    mono = cost_volume_stereo(_cpu(left), _cpu(right), cfg, denoise=False)
    fn = tiled_cost_volume_stereo(mesh, cfg, denoise=False)
    tl, tr = fn(left, right)
    _assert_disp_close(np.asarray(tl), np.asarray(mono.left_disp))
    _assert_disp_close(np.asarray(tr), np.asarray(mono.right_disp))


@pytest.fixture(scope="module")
def mesh3():
    try:
        cpus = jax.devices("cpu")
    except RuntimeError:
        cpus = []
    if len(cpus) < 8:
        pytest.skip("needs the virtual 8-device CPU mesh")
    from stereomatch_tpu.parallel import make_mesh3

    return make_mesh3(2, 2, 2, devices=cpus[:8])


def test_wta_dslab_matches_monolithic(rng):
    """D-sharded WTA (pmin/psum argmin-combine + one-slice halo) ==
    ops.select.wta_disparity exactly."""
    from jax.sharding import PartitionSpec as P
    from stereomatch_tpu.ops.select import wta_disparity
    from stereomatch_tpu.parallel import make_mesh3, wta_disparity_dslab
    from stereomatch_tpu.parallel.tiled import shard_map

    cpus = jax.devices("cpu")
    if len(cpus) < 4:
        pytest.skip("needs CPU mesh")
    m = make_mesh3(1, 1, 4, devices=cpus[:4])
    vol = rng.random((13, 21, 16)).astype(np.float32)
    # inject exact ties across shard boundaries to exercise tie-breaking
    vol[3, 4, 2] = vol[3, 4, 9] = vol[3, 4].min() - 1.0
    vol[7, 7, 7] = vol[7, 7, 8] = vol[7, 7].min() - 1.0  # ties at shard edge

    ref = np.asarray(wta_disparity(_cpu(jnp.asarray(vol)), 5))
    fn = shard_map(
        lambda v: wta_disparity_dslab(v, 5, "dslab"),
        mesh=m,
        in_specs=P(None, None, "dslab"),
        out_specs=P(),
    )
    got = np.asarray(jax.jit(fn)(vol))
    np.testing.assert_allclose(got, ref, atol=1e-6)


def test_tiled2d_equals_monolithic(mesh3, rng):
    """(tile_y, tile_x, dslab) pipeline == monolithic, with denoise."""
    h, w, d = 48, 64, 16
    cfg = CostVolumePipelineConfig(
        volume=CostVolumeConfig(min_disp=0, max_disp=d - 1),
        guided=GuidedFilterConfig(radius=3, slab=8),
        denoise=DenoiseConfig(iterations=15),
    )
    left = (rng.random((h, w, 3)) * 255).astype(np.float32)
    right = (rng.random((h, w, 3)) * 255).astype(np.float32)
    mono = cost_volume_stereo(_cpu(left), _cpu(right), cfg)

    from stereomatch_tpu.parallel import tiled2d_cost_volume_stereo

    fn = tiled2d_cost_volume_stereo(mesh3, (h, w), cfg)
    tl, tr = fn(left, right)
    _assert_disp_close(np.asarray(tl), np.asarray(mono.left_disp))
    _assert_disp_close(np.asarray(tr), np.asarray(mono.right_disp))


def test_tiled2d_no_denoise_close(mesh3, rng):
    h, w, d = 32, 48, 8
    cfg = CostVolumePipelineConfig(
        volume=CostVolumeConfig(min_disp=0, max_disp=d - 1),
        guided=GuidedFilterConfig(radius=2, slab=8),
    )
    left = (rng.random((h, w, 3)) * 255).astype(np.float32)
    right = (rng.random((h, w, 3)) * 255).astype(np.float32)
    mono = cost_volume_stereo(_cpu(left), _cpu(right), cfg, denoise=False)

    from stereomatch_tpu.parallel import tiled2d_cost_volume_stereo

    fn = tiled2d_cost_volume_stereo(mesh3, (h, w), cfg, denoise=False)
    tl, tr = fn(left, right)
    _assert_disp_close(np.asarray(tl), np.asarray(mono.left_disp))
    _assert_disp_close(np.asarray(tr), np.asarray(mono.right_disp))


def test_multihost_batch_matches_monolithic(rng):
    """(host, tile_y, tile_x, dslab) frame batch: every frame equals its
    monolithic single-frame result (the multi-host composition layer,
    SURVEY §5)."""
    try:
        cpus = jax.devices("cpu")
    except RuntimeError:
        cpus = []
    if len(cpus) < 8:
        pytest.skip("needs the virtual 8-device CPU mesh")
    from stereomatch_tpu.parallel import make_host_mesh, tiled2d_cost_volume_batch

    m = make_host_mesh(2, 2, 2, 1, devices=cpus[:8])
    h, w, d, b = 32, 48, 8, 4
    cfg = CostVolumePipelineConfig(
        volume=CostVolumeConfig(min_disp=0, max_disp=d - 1),
        guided=GuidedFilterConfig(radius=2, slab=8),
        denoise=DenoiseConfig(iterations=8),
    )
    left = (rng.random((b, h, w, 3)) * 255).astype(np.float32)
    right = (rng.random((b, h, w, 3)) * 255).astype(np.float32)
    fn = tiled2d_cost_volume_batch(m, (h, w), cfg)
    dl, dr = fn(left, right)
    dl, dr = np.asarray(dl), np.asarray(dr)
    for k in range(b):
        mono = cost_volume_stereo(_cpu(left[k]), _cpu(right[k]), cfg)
        _assert_disp_close(dl[k], np.asarray(mono.left_disp))
        _assert_disp_close(dr[k], np.asarray(mono.right_disp))


def test_multihost_batch_lr_check_matches_monolithic(rng):
    """lr_check passthrough on the batched (host, tile_y, tile_x, dslab)
    pipeline: every frame equals the monolithic single-frame result with
    lr_check on."""
    try:
        cpus = jax.devices("cpu")
    except RuntimeError:
        cpus = []
    if len(cpus) < 8:
        pytest.skip("needs the virtual 8-device CPU mesh")
    from stereomatch_tpu.parallel import make_host_mesh, tiled2d_cost_volume_batch

    m = make_host_mesh(2, 2, 2, 1, devices=cpus[:8])
    h, w, d, b = 32, 48, 8, 2
    cfg = CostVolumePipelineConfig(
        volume=CostVolumeConfig(min_disp=0, max_disp=d - 1),
        guided=GuidedFilterConfig(radius=2, slab=8),
    )
    left = (rng.random((b, h, w, 3)) * 255).astype(np.float32)
    right = (rng.random((b, h, w, 3)) * 255).astype(np.float32)
    fn = tiled2d_cost_volume_batch(m, (h, w), cfg, denoise=False, lr_check=True)
    dl, dr = fn(left, right)
    dl, dr = np.asarray(dl), np.asarray(dr)
    for k in range(b):
        mono = cost_volume_stereo(
            _cpu(left[k]), _cpu(right[k]), cfg, denoise=False, lr_check=True
        )
        _assert_disp_close(dl[k], np.asarray(mono.left_disp))
        _assert_disp_close(dr[k], np.asarray(mono.right_disp))


def test_distributed_init_noop_single_process():
    from stereomatch_tpu.parallel import distributed_init

    assert distributed_init() is False  # no coordinator env -> no-op


def test_tiled2d_lr_check_matches_monolithic(mesh3, rng):
    """lr_check on the (tile_y, tile_x, dslab) mesh: the full-row LR
    occlusion mask + directional fill run on all_gather'ed rows and must
    match the monolithic path."""
    h, w, d = 32, 48, 8
    cfg = CostVolumePipelineConfig(
        volume=CostVolumeConfig(min_disp=0, max_disp=d - 1),
        guided=GuidedFilterConfig(radius=2, slab=8),
    )
    left = (rng.random((h, w, 3)) * 255).astype(np.float32)
    right = (rng.random((h, w, 3)) * 255).astype(np.float32)
    mono = cost_volume_stereo(_cpu(left), _cpu(right), cfg, denoise=False, lr_check=True)

    from stereomatch_tpu.parallel import tiled2d_cost_volume_stereo

    fn = tiled2d_cost_volume_stereo(mesh3, (h, w), cfg, denoise=False, lr_check=True)
    tl, tr = fn(left, right)
    _assert_disp_close(np.asarray(tl), np.asarray(mono.left_disp))
    _assert_disp_close(np.asarray(tr), np.asarray(mono.right_disp))
