"""Serving layer: AOT compile from shape specs + async stream executor.

The reference has no serving story — each engine is a per-frame
executable main (src/stereo_opencv.cpp:93-176). These tests cover the
replacement: compile-before-data, executable introspection,
ticketed async submission with backpressure, and the production
SGBM-seeded-3DMST server end to end at a tiny shape.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from stereomatch_tpu.serving import (
    CompiledPipeline,
    StereoStreamServer,
    compile_mst_video_server,
    compile_sgbm_mst_server,
)


def _toy_pipeline():
    def fn(x, y):
        return {"s": x + y, "m": jnp.max(x * y)}

    spec = jax.ShapeDtypeStruct((4, 8), jnp.float32)
    return CompiledPipeline(fn, (spec, spec))


class TestCompiledPipeline:
    def test_compiles_from_specs_alone(self):
        pipe = _toy_pipeline()
        x = jnp.ones((4, 8), jnp.float32)
        out = pipe(x, 2 * x)
        np.testing.assert_allclose(np.asarray(out["s"]), 3.0)
        np.testing.assert_allclose(np.asarray(out["m"]), 2.0)

    def test_shape_mismatch_is_a_clear_error(self):
        pipe = _toy_pipeline()
        bad = jnp.ones((4, 9), jnp.float32)
        with pytest.raises(ValueError, match="fixed-shape"):
            pipe(bad, bad)

    def test_cost_analysis_exposed(self):
        pipe = _toy_pipeline()
        # 4x8 add + 4x8 mul + reduce-max: > 0 flops on every backend
        assert pipe.flops > 0
        assert pipe.in_specs[0].shape == (4, 8)

    def test_serialize_deserialize_roundtrip(self):
        """AOT executable serialization: a restarted
        process loads the serialized executable instead of recompiling
        — bit-identical outputs, specs preserved. XLA:CPU's AOT loader
        is broken on some hosts (compile-time machine features like
        +prefer-no-scatter mismatch the load-time host; execution then
        raises "Function ... not found") — _cached_pipeline guards that
        with a validated zero-input run, and this test skips when it
        hits the same breakage."""
        pipe = _toy_pipeline()
        blob = pipe.serialize()
        assert isinstance(blob, bytes) and len(blob) > 0
        pipe2 = CompiledPipeline.deserialize(blob)
        x = jnp.ones((4, 8), jnp.float32)
        a = pipe(x, 2 * x)
        try:
            b = jax.block_until_ready(pipe2(x, 2 * x))
        except Exception as e:  # the documented XLA:CPU AOT loader bug
            pytest.skip(f"XLA:CPU AOT load broken on this host: {e}")
        np.testing.assert_array_equal(np.asarray(a["s"]), np.asarray(b["s"]))
        np.testing.assert_array_equal(np.asarray(a["m"]), np.asarray(b["m"]))
        assert pipe2.in_specs[0].shape == (4, 8)
        with pytest.raises(ValueError, match="fixed-shape"):
            pipe2(jnp.ones((4, 9)), jnp.ones((4, 9)))


def test_server_executable_cache_roundtrip(tmp_path):
    """compile_sgbm_mst_server(cache_dir=...): the first build writes
    serialized stage executables; a second build (a restarted serving
    process) loads them and produces identical frames. Stale-key safety:
    a different fine_iterations misses the cache (new files appear)."""
    from stereomatch_tpu.config import production_mst_config

    H, W, D = 48, 64, 16
    cfg = production_mst_config(
        D, min_cc_size=20, c=800.0, forest_backend="device"
    )
    cache = str(tmp_path / "exec_cache")
    srv1 = compile_sgbm_mst_server(
        H, W, cfg=cfg, fine_iterations=2, staged=True, cache_dir=cache)
    import os
    files1 = set(os.listdir(cache))
    assert len(files1) == 4  # vol / seed / refine0 / refine1
    rng = np.random.default_rng(7)
    img = (rng.random((H, W, 3)) * 255).astype(np.float32)
    left, right = img, np.roll(img, -3, axis=1)
    dl1, dr1 = srv1.collect(srv1.submit_pair(left, right, seed=0))
    # "restarted process": a fresh server from the same cache dir
    srv2 = compile_sgbm_mst_server(
        H, W, cfg=cfg, fine_iterations=2, staged=True, cache_dir=cache)
    # same key set: a hit, or (where the backend's AOT loader is broken,
    # e.g. XLA:CPU on this host) a validated fallback that recompiles
    # and overwrites the same entries — never a silent wrong executable
    assert set(os.listdir(cache)) == files1
    dl2, dr2 = srv2.collect(srv2.submit_pair(left, right, seed=0))
    np.testing.assert_array_equal(dl1, dl2)
    np.testing.assert_array_equal(dr1, dr2)
    # different static knob -> different keys, no false hit
    compile_sgbm_mst_server(
        H, W, cfg=cfg, fine_iterations=3, staged=True, cache_dir=cache)
    assert len(set(os.listdir(cache)) - files1) == 2  # the 2 refine stages


class TestStreamServer:
    def test_tickets_collect_in_any_order(self):
        server = StereoStreamServer(_toy_pipeline(), capacity=2)
        xs = [jnp.full((4, 8), float(i)) for i in range(4)]
        tickets = [server.submit(x, x) for x in xs]
        # out-of-order collect; backpressure already forced 0 and 1 done
        got3 = server.collect(tickets[3])
        got0 = server.collect(tickets[0])
        np.testing.assert_allclose(got3["s"], 6.0)
        np.testing.assert_allclose(got0["s"], 0.0)
        rest = server.drain()
        assert len(rest) == 2
        np.testing.assert_allclose(rest[0]["s"], 2.0)
        np.testing.assert_allclose(rest[1]["s"], 4.0)

    def test_collect_twice_raises(self):
        server = StereoStreamServer(_toy_pipeline(), capacity=1)
        t = server.submit(jnp.ones((4, 8)), jnp.ones((4, 8)))
        server.collect(t)
        with pytest.raises(KeyError):
            server.collect(t)

    def test_capacity_validated(self):
        with pytest.raises(ValueError):
            StereoStreamServer(_toy_pipeline(), capacity=0)


class TestSgbmMstServer:
    """One AOT compile of the real fused production pipeline (tiny)."""

    H, W, D = 48, 64, 16

    @pytest.fixture(scope="class")
    def server(self):
        from stereomatch_tpu.config import production_mst_config

        cfg = production_mst_config(
            self.D, min_cc_size=20, c=800.0
        )
        return compile_sgbm_mst_server(
            self.H, self.W, cfg=cfg, fine_iterations=2, capacity=2
        )

    @pytest.fixture(scope="class")
    def pair(self):
        rng = np.random.default_rng(7)
        img = (rng.random((self.H, self.W, 3)) * 255).astype(np.float32)
        for _ in range(2):
            img = (img + np.roll(img, 1, 0) + np.roll(img, 1, 1)) / 3
        left = img
        right = np.roll(img, -3, axis=1)
        return left, right

    def test_stream_end_to_end(self, server, pair):
        left, right = pair
        t0 = server.submit_pair(left, right)
        t1 = server.submit_pair(right, left)  # distinct second frame
        dl0, dr0 = server.collect(t0)
        dl1, _ = server.collect(t1)
        assert dl0.shape == (self.H, self.W)
        assert np.isfinite(dl0).all() and np.isfinite(dr0).all()
        assert float(dl0.max()) <= self.D - 1 + 1e-3
        assert float(dl0.min()) >= 0.0
        # the two frames saw different inputs -> different maps
        assert not np.allclose(dl0, dl1)

    def test_submit_matches_direct_executable_call(self, server, pair):
        """submit_pair wiring == calling the compiled program directly
        (same executable, same key) — no recompilation involved."""
        left, right = pair
        t = server.submit_pair(left, right, seed=0)
        dl, dr = server.collect(t)
        dl2, dr2 = server.pipeline(
            jnp.asarray(left), jnp.asarray(right), jax.random.PRNGKey(0)
        )
        np.testing.assert_array_equal(dl, np.asarray(dl2))
        np.testing.assert_array_equal(dr, np.asarray(dr2))

    def test_capacity_planning_numbers(self, server):
        assert server.pipeline.flops > 0
        assert server.pipeline.peak_hbm_bytes >= 0

    def test_staged_pipeline_matches_fused(self, server, pair):
        """staged=True (four chained executables, StagedPipeline) is the
        SAME composition and RNG stream as the fused single-program
        server — only the program partitioning differs, so any output
        difference is XLA fusion fp drift across stage boundaries."""
        from stereomatch_tpu.config import production_mst_config
        from stereomatch_tpu.serving import StagedPipeline

        cfg = production_mst_config(
            self.D, min_cc_size=20, c=800.0
        )
        staged = compile_sgbm_mst_server(
            self.H, self.W, cfg=cfg, fine_iterations=2, capacity=2,
            staged=True,
        )
        assert isinstance(staged.pipeline, StagedPipeline)
        left, right = pair
        sl, sr = staged.collect(staged.submit_pair(left, right, seed=0))
        fl, fr = server.collect(server.submit_pair(left, right, seed=0))
        for s, f in ((sl, fl), (sr, fr)):
            # discrete label flips only at fp ties: allow <1% of pixels
            assert np.mean(np.abs(s - f) > 0.5) < 0.01
            assert np.mean(np.abs(s - f)) < 0.05
        # cost introspection aggregates over the stage executables
        assert staged.pipeline.flops >= server.pipeline.flops * 0.5
        assert staged.pipeline.in_specs[0].shape == (self.H, self.W, 3)


class _Poison:
    """Stands in for a device buffer lost to a worker restart:
    materializing it raises, like np.asarray on a dead jax.Array."""

    def __array__(self, dtype=None, copy=None):
        raise RuntimeError("UNAVAILABLE: worker process crashed")


class _FlakyPipeline:
    """Returns poisoned outputs for the first `fail_n` calls, then real
    arrays — the shape of a worker crash + restart."""

    def __init__(self, fail_n=1, value=7.0):
        self.fail_n = fail_n
        self.calls = 0
        self.value = value

    def __call__(self, *args):
        self.calls += 1
        if self.calls <= self.fail_n:
            return _Poison(), _Poison()
        x = jnp.full((4, 8), self.value)
        return x, x


class TestFailureRecovery:
    """Preemption/crash recovery: a worker restart loses device buffers;
    with retries the executor replays the frame from host-kept inputs
    (SURVEY §5: the reference has no failure handling at all)."""

    def test_retry_replays_lost_frame(self):
        pipe = _FlakyPipeline(fail_n=1)
        server = StereoStreamServer(pipe, capacity=2, retries=1)
        t = server.submit(np.ones((4, 8), np.float32))
        a, b = server.collect(t)
        np.testing.assert_allclose(a, 7.0)
        assert server.failures == 1
        assert pipe.calls == 2  # original + replay

    def test_no_retries_propagates(self):
        server = StereoStreamServer(_FlakyPipeline(fail_n=1), capacity=1)
        t = server.submit(np.ones((4, 8), np.float32))
        with pytest.raises(RuntimeError, match="UNAVAILABLE"):
            server.collect(t)

    def test_retries_exhausted_raises(self):
        server = StereoStreamServer(
            _FlakyPipeline(fail_n=5), capacity=1, retries=2
        )
        t = server.submit(np.ones((4, 8), np.float32))
        with pytest.raises(RuntimeError, match="UNAVAILABLE"):
            server.collect(t)
        assert server.failures == 2

    def test_dispatch_time_failure_recovers_at_submit(self):
        """When dispatch raises eagerly (dead INPUT buffers after a
        restart), submit itself replays instead of propagating."""

        class _RaisingPipeline:
            calls = 0

            def __call__(self, *args):
                self.calls += 1
                if self.calls == 1:
                    raise RuntimeError("UNAVAILABLE: worker restarting")
                x = jnp.full((4, 8), 3.0)
                return x, x

        pipe = _RaisingPipeline()
        server = StereoStreamServer(pipe, capacity=1, retries=1)
        t = server.submit(np.ones((4, 8), np.float32))
        a, _ = server.collect(t)
        np.testing.assert_allclose(a, 3.0)
        assert server.failures == 1 and pipe.calls == 2

    def test_video_refine_crash_replays_as_keyframe(self):
        """A refine frame whose chained device seeds died is replayed
        through the KEYFRAME pipeline (the temporal chain cannot survive
        a restart; re-keying is the honest recovery)."""
        from stereomatch_tpu.serving import VideoStreamServer

        key_pipe = _FlakyPipeline(fail_n=0, value=100.0)  # never fails

        class _RefinePoison:
            calls = 0

            def __call__(self, *args):
                self.calls += 1
                return _Poison(), _Poison()

        ref_pipe = _RefinePoison()
        server = VideoStreamServer(key_pipe, ref_pipe, capacity=2, retries=1)
        x = np.zeros((4, 8), np.float32)
        t0 = server.submit_pair(x, x)  # keyframe, fine
        t1 = server.submit_pair(x, x)  # refine -> poisoned outputs
        np.testing.assert_allclose(server.collect(t0)[0], 100.0)
        a, _ = server.collect(t1)  # replayed through the keyframe path
        np.testing.assert_allclose(a, 100.0)
        assert server.failures == 1
        assert ref_pipe.calls == 1 and key_pipe.calls == 2


def test_video_server_refine_path_absolute_gt_sequence():
    """The SERVED temporal composition — raw dense pre-LR-check maps
    chained on device, no _apply_smoothness/lr_consistency inside the
    frame programs (deliberately different from the offline
    sgbm_mst_video, which seeds from checked+filled maps) — meets
    absolute GT gates on every frame of a moving sequence (ADVICE r3:
    the wiring tests alone left served quality ungated).

    Measured (120x160, D=24, drift 2 px/frame, production config,
    ti=2 / temporal_refine_start=4): keyframe epe 0.214 / bad2 0.11%;
    temporal frames epe 0.209-0.212 / bad2 <= 0.10%, LR-valid fraction
    0.62-0.63 — gates carry >3x headroom."""
    from stereomatch_tpu.config import production_mst_config
    from stereomatch_tpu.eval import disparity_metrics
    from stereomatch_tpu.ops.postprocess import lr_consistency
    from stereomatch_tpu.synthetic import render_sequence, scene_eval_mask

    H, W, D = 120, 160, 24
    seq = render_sequence(2, 3, H, W, D, drift=2.0)
    cfg = production_mst_config(
        D, min_cc_size=100, c=2000.0, forest_backend="device"
    )
    srv = compile_mst_video_server(
        H, W, cfg=cfg, fine_iterations=4, temporal_iterations=2,
        temporal_refine_start=4.0,
    )
    tickets = [srv.submit_pair(sc.left, sc.right) for sc in seq]
    for i, (sc, t) in enumerate(zip(seq, tickets)):
        dl, dr = srv.collect(t)
        dl_checked, valid = lr_consistency(
            jnp.asarray(dl), jnp.asarray(dr), float(D), fill=False
        )
        v = np.asarray(valid) & scene_eval_mask(sc)
        assert v.mean() > 0.45, (i, v.mean())
        mm = disparity_metrics(np.asarray(dl_checked), sc.disp_left, v)
        assert mm["epe"] < 0.8, (i, mm)
        assert mm["bad2"] < 0.03, (i, mm)


def test_video_server_reuse_forest_absolute_gt_sequence():
    """reuse_forest=True: temporal frames refine on the KEYFRAME's
    (stale) device forests — the forest build drops off the steady-state
    critical path (round-5; the reference rebuilds per frame,
    src/stereo_Yin.cpp:207). Gated ABSOLUTELY on the same moving GT
    sequence as the rebuild-every-frame server, with the same
    thresholds: a stale forest must not cost measurable quality at this
    drift. Also checks keyframe parity with the rebuild server (same
    math, same RNG stream) and that reset() drops the chained forest."""
    from stereomatch_tpu.config import production_mst_config
    from stereomatch_tpu.eval import disparity_metrics
    from stereomatch_tpu.ops.postprocess import lr_consistency
    from stereomatch_tpu.synthetic import render_sequence, scene_eval_mask

    H, W, D = 120, 160, 24
    seq = render_sequence(2, 3, H, W, D, drift=2.0)
    cfg = production_mst_config(
        D, min_cc_size=100, c=2000.0, forest_backend="device"
    )
    srv = compile_mst_video_server(
        H, W, cfg=cfg, fine_iterations=4, temporal_iterations=2,
        temporal_refine_start=4.0, reuse_forest=True,
    )
    base = compile_mst_video_server(
        H, W, cfg=cfg, fine_iterations=4, temporal_iterations=2,
        temporal_refine_start=4.0,
    )
    assert srv.reuse_forest and srv._prev_forest is None
    tickets = [srv.submit_pair(sc.left, sc.right, seed=i)
               for i, sc in enumerate(seq)]
    assert srv._prev_forest is not None  # keyframe chained its forests
    tb = [base.submit_pair(sc.left, sc.right, seed=i)
          for i, sc in enumerate(seq)]
    for i, (sc, t, t2) in enumerate(zip(seq, tickets, tb)):
        dl, dr = srv.collect(t)
        bl_, br_ = base.collect(t2)
        if i == 0:
            # keyframes build fresh forests in both servers: same math,
            # same RNG stream -> same maps (fp-tie label flips only)
            assert np.mean(np.abs(dl - bl_) > 0.5) < 0.01
        dl_checked, valid = lr_consistency(
            jnp.asarray(dl), jnp.asarray(dr), float(D), fill=False
        )
        v = np.asarray(valid) & scene_eval_mask(sc)
        assert v.mean() > 0.45, (i, v.mean())
        mm = disparity_metrics(np.asarray(dl_checked), sc.disp_left, v)
        assert mm["epe"] < 0.8, (i, mm)
        assert mm["bad2"] < 0.03, (i, mm)
    srv.reset()
    assert srv._prev_forest is None


def test_server_raw_volume_mode_absolute_gt():
    """volume_guided=False (raw adgrad volume, no guided-filter stack —
    the reference's own 3DMST consumes its mc-cnn volume unfiltered,
    src/stereo_Yin.cpp:150-210): ~3x fewer volume passes; served output
    still meets the absolute GT gates (measured at 240x320: epe 0.216
    vs guided 0.193, bad2 0.57% vs 0.20% — see builtin_cost_volumes
    docstring for the full ablation)."""
    from stereomatch_tpu.config import production_mst_config
    from stereomatch_tpu.eval import disparity_metrics
    from stereomatch_tpu.ops.postprocess import lr_consistency
    from stereomatch_tpu.synthetic import render_scene, scene_eval_mask

    H, W, D = 120, 160, 24
    sc = render_scene(3, H, W, D)
    cfg = production_mst_config(
        D, min_cc_size=100, c=2000.0, forest_backend="device"
    )
    srv = compile_sgbm_mst_server(
        H, W, cfg=cfg, fine_iterations=4, volume_guided=False)
    dl, dr = srv.collect(srv.submit_pair(sc.left, sc.right, seed=0))
    dl_checked, valid = lr_consistency(
        jnp.asarray(dl), jnp.asarray(dr), float(D), fill=False
    )
    v = np.asarray(valid) & scene_eval_mask(sc)
    assert v.mean() > 0.4, v.mean()
    mm = disparity_metrics(np.asarray(dl_checked), sc.disp_left, v)
    assert mm["epe"] < 0.8, mm
    assert mm["bad2"] < 0.03, mm


def test_video_server_scene_cut_detection():
    """Quality-triggered reseed (round 5): a HARD SCENE CUT between
    frames (two unrelated GT scenes) collapses the temporal frame's
    LR-valid fraction; with scene_cut_ratio armed the server detects it
    on device and replays the frame through the keyframe pipeline.
    Asserts: (a) exactly one scene cut fires, (b) the replayed frame
    matches a FRESH KEYFRAME on the new scene bit-for-bit (same key,
    same program — measured identical on the real FLIR 000020->000040
    jump too), (c) a smooth drift sequence fires NO cuts."""
    from stereomatch_tpu.config import production_mst_config
    from stereomatch_tpu.synthetic import render_scene, render_sequence

    H, W, D = 120, 160, 24
    sc_a = render_scene(2, H, W, D)
    # hard cut = the MIRRORED scene: same image statistics, maximally
    # incoherent motion field (measured here: temporal LR-valid frac
    # 0.33 vs keyframe 0.90; an unrelated same-statistics scene reads
    # 0.59 — borderline; the real FLIR 000020->000040 jump collapses
    # the co-valid fraction 55%->18% and triggers at the same 0.6)
    cut_l, cut_r = sc_a.left[:, ::-1], sc_a.right[:, ::-1]
    cfg = production_mst_config(
        D, min_cc_size=100, c=2000.0, forest_backend="device"
    )
    kwargs = dict(cfg=cfg, fine_iterations=4, temporal_iterations=2,
                  temporal_refine_start=4.0, reuse_forest=True)
    srv = compile_mst_video_server(H, W, scene_cut_ratio=0.6, **kwargs)
    t0 = srv.submit_pair(sc_a.left, sc_a.right, seed=0)
    t1 = srv.submit_pair(cut_l, cut_r, seed=1)
    srv.collect(t0)
    dl1, dr1 = srv.collect(t1)
    assert srv.scene_cuts == 1, srv.scene_cuts
    # replay == fresh keyframe on the new scene (same PRNGKey(1), same
    # pipeline, fp-tie label flips only)
    base = compile_mst_video_server(H, W, **kwargs)
    kl, kr = base.collect(base.submit_pair(cut_l, cut_r, seed=1))
    assert np.mean(np.abs(dl1 - kl) > 0.5) < 0.01
    assert np.mean(np.abs(dr1 - kr) > 0.5) < 0.01
    # smooth sequence: no false triggers at the same threshold
    seq = render_sequence(2, 3, H, W, D, drift=2.0)
    srv.reset()
    ts = [srv.submit_pair(s.left, s.right, seed=i)
          for i, s in enumerate(seq)]
    for t in ts:
        srv.collect(t)
    assert srv.scene_cuts == 1, srv.scene_cuts  # unchanged: no new cuts


def test_video_server_raw_volume_reuse_forest_absolute_gt_sequence():
    """The production stream configuration END TO END: raw adgrad volume
    (volume_guided=False — the reference's own 3DMST consumes its
    mc-cnn volume unfiltered, src/stereo_Yin.cpp:150-210) AND
    reuse_forest=True (temporal frames refine on the keyframe's stale
    forests). Each flag is GT-gated separately above; this gates the
    COMBINATION on the moving sequence at the same absolute thresholds,
    so the configuration chip_smoke.py serves at full size rests on a
    tested one."""
    from stereomatch_tpu.config import production_mst_config
    from stereomatch_tpu.eval import disparity_metrics
    from stereomatch_tpu.ops.postprocess import lr_consistency
    from stereomatch_tpu.synthetic import render_sequence, scene_eval_mask

    H, W, D = 120, 160, 24
    seq = render_sequence(2, 3, H, W, D, drift=2.0)
    cfg = production_mst_config(
        D, min_cc_size=100, c=2000.0, forest_backend="device"
    )
    srv = compile_mst_video_server(
        H, W, cfg=cfg, fine_iterations=4, temporal_iterations=2,
        temporal_refine_start=4.0, reuse_forest=True, volume_guided=False,
    )
    tickets = [srv.submit_pair(sc.left, sc.right, seed=i)
               for i, sc in enumerate(seq)]
    for i, (sc, t) in enumerate(zip(seq, tickets)):
        dl, dr = srv.collect(t)
        dl_checked, valid = lr_consistency(
            jnp.asarray(dl), jnp.asarray(dr), float(D), fill=False
        )
        v = np.asarray(valid) & scene_eval_mask(sc)
        assert v.mean() > 0.45, (i, v.mean())
        mm = disparity_metrics(np.asarray(dl_checked), sc.disp_left, v)
        assert mm["epe"] < 0.8, (i, mm)
        assert mm["bad2"] < 0.03, (i, mm)


def test_video_server_reuse_forest_staged_matches_fused():
    """staged=True + reuse_forest=True: the 5-executable keyframe chain
    and the 3-executable temporal chain reproduce the fused reuse-forest
    pair's outputs (same composition and RNG streams; the forest stage
    is chained as a device pytree)."""
    from stereomatch_tpu.config import production_mst_config
    from stereomatch_tpu.serving import StagedPipeline
    from stereomatch_tpu.synthetic import render_sequence

    H, W, D = 96, 128, 16
    seq = render_sequence(2, 2, H, W, D, drift=2.0)
    cfg = production_mst_config(
        D, min_cc_size=20, c=800.0, forest_backend="device"
    )
    kw = dict(cfg=cfg, fine_iterations=2, temporal_iterations=1,
              reuse_forest=True)
    fused = compile_mst_video_server(H, W, **kw)
    staged = compile_mst_video_server(H, W, staged=True, **kw)
    assert isinstance(staged.pipeline, StagedPipeline)
    # the temporal chain shares the keyframe chain's volume builder
    assert staged.refine_pipeline.stages[0] is staged.pipeline.stages[0]
    for i, sc in enumerate(seq):
        (fl, fr) = fused.collect(fused.submit_pair(sc.left, sc.right, seed=i))
        (sl, sr) = staged.collect(
            staged.submit_pair(sc.left, sc.right, seed=i))
        for s, f in ((sl, fl), (sr, fr)):
            assert np.mean(np.abs(s - f) > 0.5) < 0.01
            assert np.mean(np.abs(s - f)) < 0.05


class TestVideoCadence:
    """Keyframe cadence is frames-since-last-keyframe, rephased by
    reset() (ADVICE r3: the old global-ticket modulo decoupled the
    cadence from a scene cut)."""

    @staticmethod
    def _toy_video_server(reseed_every):
        from stereomatch_tpu.serving import VideoStreamServer

        def keyframe(l, r, key):
            # marks the keyframe path: outputs pinned to 100
            return jnp.zeros_like(l) + 100.0, jnp.zeros_like(r) + 100.0

        def refine(l, r, pdl, pdr, key):
            # marks the refine path: increments the chained state
            return pdl + 1.0, pdr + 1.0

        img = jax.ShapeDtypeStruct((4, 8), jnp.float32)
        key = jax.ShapeDtypeStruct((2,), jnp.uint32)
        return VideoStreamServer(
            CompiledPipeline(keyframe, (img, img, key)),
            CompiledPipeline(refine, (img, img, img, img, key)),
            capacity=2,
            reseed_every=reseed_every,
        )

    def test_cadence_counts_from_last_keyframe(self):
        server = self._toy_video_server(reseed_every=3)
        x = np.zeros((4, 8), np.float32)
        vals = []
        for _ in range(7):
            t = server.submit_pair(x, x)
            vals.append(float(server.collect(t)[0][0, 0]))
        # keyframes at 0, 3, 6: 100, then two refines, then re-key
        assert vals == [100.0, 101.0, 102.0, 100.0, 101.0, 102.0, 100.0]

    def test_reset_rephases_cadence(self):
        server = self._toy_video_server(reseed_every=3)
        x = np.zeros((4, 8), np.float32)
        for _ in range(2):  # tickets 0 (key), 1 (refine)
            server.collect(server.submit_pair(x, x))
        server.reset()  # scene cut at ticket 2
        vals = [
            float(server.collect(server.submit_pair(x, x))[0][0, 0])
            for _ in range(4)
        ]
        # post-cut: keyframe, then a FULL reseed_every run of refines
        # (the old i %% reseed_every would have re-keyed at ticket 3)
        assert vals == [100.0, 101.0, 102.0, 100.0]


class TestVideoServer:
    """The stateful temporal video executor: SGBM keyframe program +
    refine-only steady-state program, chained on device."""

    H, W, D = 48, 64, 16

    @pytest.fixture(scope="class")
    def server(self):
        from stereomatch_tpu.config import production_mst_config

        cfg = production_mst_config(
            self.D, min_cc_size=20, c=800.0
        )
        return compile_mst_video_server(
            self.H, self.W, cfg=cfg, fine_iterations=2,
            temporal_iterations=1, capacity=2,
        )

    @pytest.fixture(scope="class")
    def pair(self):
        rng = np.random.default_rng(3)
        img = (rng.random((self.H, self.W, 3)) * 255).astype(np.float32)
        for _ in range(2):
            img = (img + np.roll(img, 1, 0) + np.roll(img, 1, 1)) / 3
        return img, np.roll(img, -3, axis=1)

    def test_keyframe_then_refine_stream(self, server, pair):
        left, right = pair
        t0 = server.submit_pair(left, right)
        t1 = server.submit_pair(left, right)  # same pixels, refine path
        t2 = server.submit_pair(left, right)
        dl0, dr0 = server.collect(t0)
        dl1, _ = server.collect(t1)
        dl2, _ = server.collect(t2)
        for d in (dl0, dl1, dl2):
            assert d.shape == (self.H, self.W)
            assert np.isfinite(d).all()
            assert 0.0 <= float(d.min()) and float(d.max()) <= self.D - 1 + 1e-3
        # the refine frames took the temporal path: wiring parity with a
        # direct call of the refine executable on frame 0's outputs
        dl1_direct, _ = server.refine_pipeline(
            jnp.asarray(left), jnp.asarray(right),
            jnp.asarray(dl0), jnp.asarray(dr0), jax.random.PRNGKey(1),
        )
        np.testing.assert_array_equal(dl1, np.asarray(dl1_direct))

    def test_reset_reseeds(self, server, pair):
        left, right = pair
        server.reset()
        t = server.submit_pair(left, right, seed=0)
        dl, _ = server.collect(t)
        # after reset the frame went through the keyframe pipeline
        dl_direct, _ = server.pipeline(
            jnp.asarray(left), jnp.asarray(right), jax.random.PRNGKey(0)
        )
        np.testing.assert_array_equal(dl, np.asarray(dl_direct))

    def test_staged_video_matches_fused(self, server, pair):
        """staged=True video serving: both chained frame programs
        (keyframe and temporal refine) reproduce the fused pair's
        outputs — same composition, same RNG streams."""
        from stereomatch_tpu.config import production_mst_config
        from stereomatch_tpu.serving import StagedPipeline

        cfg = production_mst_config(
            self.D, min_cc_size=20, c=800.0
        )
        staged = compile_mst_video_server(
            self.H, self.W, cfg=cfg, fine_iterations=2,
            temporal_iterations=1, capacity=2, staged=True,
        )
        assert isinstance(staged.pipeline, StagedPipeline)
        assert isinstance(staged.refine_pipeline, StagedPipeline)
        # the temporal chain shares the keyframe chain's volume builder
        assert staged.refine_pipeline.stages[0] is staged.pipeline.stages[0]
        left, right = pair
        server.reset()
        # explicit matching seeds: the class-scoped fused server's ticket
        # counter is NOT at 0 here (earlier tests advanced it, reset()
        # keeps it), so default seeds would diverge between the servers
        ts = [staged.submit_pair(left, right, seed=i) for i in range(2)]
        tf = [server.submit_pair(left, right, seed=i) for i in range(2)]
        for t_s, t_f in zip(ts, tf):
            (sl, sr), (fl, fr) = staged.collect(t_s), server.collect(t_f)
            for s, f in ((sl, fl), (sr, fr)):
                # discrete label flips only at fp ties: <1% of pixels
                assert np.mean(np.abs(s - f) > 0.5) < 0.01
                assert np.mean(np.abs(s - f)) < 0.05
