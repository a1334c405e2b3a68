"""Smoke run of the stereo engine on NVIDIA GPUs, through its own entry points.

    python chip_smoke.py            # one card
    python chip_smoke.py --cards 4  # the four-card (frame, tile) mesh only

One card, in one process:

- card: the card's name and power limit (nvidia-smi, from a child that
  stays off JAX), its JAX device kind and the JAX version;
- main path: a seeded synthetic 960x1280 video sequence served by
  `serving.compile_mst_video_server(960, 1280, reuse_forest=True,
  volume_guided=False)` with the production 3DMST config at 128
  disparities. Keyframes run the cost volume, 8-path SGBM, the plane seed,
  the device forest build and the label_cost + tree_filter ladder for both
  views; temporal frames refine on the keyframe's forests. Prints compile
  time (set-up), steady-state keyframe and temporal frame times (ended by
  the collect), peak device memory, and gates every frame against the
  ground truth;
- GPU against CPU: the same server at 240x320x32 on the GPU and on the CPU
  backend, its keyframe and temporal programs each fed identical inputs
  and the same threefry keys;
- the two layers that once had hand-written kernels, at full width:
  `ops/sgbm.aggregate_8path` (exact against the CPU backend on a band of
  rows) and `ops/mst._segmented_cumsum_mm` on the main path's forest
  (against a float64 oracle).

`--cards 4` runs only the stream app's (frame, tile) mesh over four cards
(`parallel/tiled.py::tiled_cost_volume_batch`, 2x2) on four 960x1280
frames at max_disp=127, against the single-card `cost_volume_stereo`.

The script fails (non-zero exit, no result line) when JAX finds no GPU or
any phase fails. Its last line on stdout is one JSON object,
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
JAX_COMPILATION_CACHE_DIR, when set, holds the compile cache; otherwise it
is `.jax_cache` beside this file.

Importing this module touches no device and does not import JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

FULL = (960, 1280, 128)  # the BASELINE.json stream: H, W, disparities
REDUCED = (240, 320, 32)
N_FRAMES, RESEED_EVERY = 6, 3  # keyframes at 0 and 3
SEED = 0

# ground-truth gates of tests/test_serving.py's served-sequence tests
VALID_MIN, EPE_MAX, BAD2_MAX = 0.45, 0.8, 0.03
# GPU vs CPU: fp32 sums are taken in another order on each backend, and a
# near-tie between plane labels can flip either way; a flipped label moves
# a pixel by more than half a disparity, so at most this share may differ.
DIFF_PX, DIFF_SHARE_MAX = 0.5, 0.01
# Tiled vs single-card cost-volume pipeline. The guided filter's box sums
# are differences of running sums, which span a tile plus its halo in the
# tiled pipeline and the whole image on one card, so their f32 rounding
# differs; at 960x1280x128 that flips WTA near-ties on ~0.005% of pixels,
# and the 100-iteration denoise then spreads each flip over its
# neighbourhood at amplitudes above tests/test_parallel.py's 0.02 px (1-3%
# of pixels on four H100s). So the gate counts flips, pixels moved by more
# than half a disparity, and allows 0.2% (3x the worst frame measured);
# a halo fault along a tile boundary moves whole rows and fails it.
TILE_PX, TILE_SHARE_MAX = 0.5, 0.002
TEST_ATOL = 0.02  # reported beside the gate


def compile_cache_dir(environ, root: str = ROOT) -> str:
    """The compile cache: JAX_COMPILATION_CACHE_DIR when set, else a fixed
    path beside this file (the path is part of the cache key)."""
    return environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(root, ".jax_cache")


def require_gpu(devices) -> None:
    """Refuse to run anywhere but on a GPU: numbers from another backend
    must never be reported as the card's."""
    if not devices or devices[0].platform != "gpu":
        found = devices[0].platform if devices else "no device"
        raise RuntimeError(f"no GPU: JAX found {found}; this smoke run needs an NVIDIA GPU")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def gt_gate(disp_l, disp_r, scene, max_disp: int) -> dict:
    """LR-check the served pair and score the left map against the scene's
    ground truth on the LR-valid, non-occluded interior."""
    import jax.numpy as jnp
    import numpy as np

    from stereomatch_tpu.eval import disparity_metrics
    from stereomatch_tpu.ops.postprocess import lr_consistency
    from stereomatch_tpu.synthetic import scene_eval_mask

    checked, valid = lr_consistency(
        jnp.asarray(disp_l), jnp.asarray(disp_r), float(max_disp), fill=False
    )
    v = np.asarray(valid) & scene_eval_mask(scene)
    m = disparity_metrics(np.asarray(checked), scene.disp_left, v)
    share = float(v.mean())
    ok = share > VALID_MIN and m["epe"] < EPE_MAX and m["bad2"] < BAD2_MAX
    return {"valid_share": share, "epe": float(m["epe"]), "bad2": float(m["bad2"]), "ok": bool(ok)}


def _timed(fn, reps: int = 5) -> float:
    """Median seconds of fn() after one warm-up; fn ends in block_until_ready."""
    fn()
    ts = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t)
    return statistics.median(ts)


@contextlib.contextmanager
def _on_cpu_uncached(cpu):
    """Run on the CPU backend with the persistent compile cache off: an
    XLA:CPU executable is built for its host's instruction set, and one
    loaded from a cache filled on another host can fault."""
    import jax
    from jax.experimental.compilation_cache import compilation_cache as cc

    was = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    cc.reset_cache()
    try:
        with jax.default_device(cpu):
            yield
    finally:
        jax.config.update("jax_enable_compilation_cache", was)
        cc.reset_cache()


def _server(h: int, w: int, d: int, reseed_every: int):
    from stereomatch_tpu.config import production_mst_config
    from stereomatch_tpu.serving import compile_mst_video_server

    # at the stream's 128 disparities the server's own default config runs
    cfg = None if d == 128 else production_mst_config(d, forest_backend="device")
    return compile_mst_video_server(
        h, w, cfg=cfg, reuse_forest=True, volume_guided=False,
        reseed_every=reseed_every,
    )


def phase_main_path(h, w, d, n_frames, reseed_every, seed, device):
    """Serve the sequence one frame at a time and gate every frame. Returns
    (all gates passed, the last keyframe's left-view forest)."""
    from stereomatch_tpu.synthetic import render_sequence

    t = time.perf_counter()
    seq = render_sequence(seed, n_frames, h, w, d)
    print(f"main_path: rendered {n_frames} frames of {h}x{w} (max_disp {d}) "
          f"in {time.perf_counter() - t:.1f} s (host set-up)")
    t = time.perf_counter()
    srv = _server(h, w, d, reseed_every)
    compile_s = time.perf_counter() - t
    print(f"main_path: compile_s={compile_s:.2f} (keyframe + temporal programs, set-up)")
    key_s, temp_s, ok = [], [], True
    for i, sc in enumerate(seq):
        is_key = i == 0 or bool(reseed_every) and i % reseed_every == 0
        t = time.perf_counter()
        dl, dr = srv.collect(srv.submit_pair(sc.left, sc.right))
        dt = time.perf_counter() - t
        (key_s if is_key else temp_s).append(dt)
        g = gt_gate(dl, dr, sc, d)
        ok &= g["ok"]
        print(f"main_path: frame {i} {'keyframe' if is_key else 'temporal'} "
              f"{dt * 1e3:.1f} ms valid_share={g['valid_share']:.4f} "
              f"epe={g['epe']:.4f} bad2={g['bad2']:.5f} gate={'pass' if g['ok'] else 'FAIL'}")
    # the first frame of each kind pays one-off costs; steady state excludes it
    key_ms = 1e3 * statistics.median(key_s[1:] or key_s)
    temp_ms = 1e3 * statistics.median(temp_s[1:] or temp_s)
    peak = device.memory_stats()["peak_bytes_in_use"]
    print(f"main_path: steady keyframe_ms={key_ms:.1f} temporal_ms={temp_ms:.1f} "
          f"peak_bytes_in_use={peak} gates={'pass' if ok else 'FAIL'}")
    return ok, srv._prev_forest[0]


def phase_gpu_vs_cpu(h, w, d, seed, gpu, cpu) -> bool:
    """The reduced-size server's two programs on the GPU and on the CPU
    backend, each fed identical inputs: the keyframe program one frame and
    key; the temporal program the next frame, its key, and the GPU
    keyframe's maps and forests. Chained over a sequence instead, each
    backend would seed from its own previous output and every earlier
    label flip would compound."""
    import jax
    import numpy as np

    from stereomatch_tpu.synthetic import render_sequence

    s0, s1 = render_sequence(seed, 2, h, w, d)
    host = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    outs, state = {}, None
    for name, dev in (("gpu", gpu), ("cpu", cpu)):
        place = jax.default_device(gpu) if name == "gpu" else _on_cpu_uncached(cpu)
        with place:
            srv = _server(h, w, d, 0)
            key_maps = srv.collect(srv.submit_pair(s0.left, s0.right, seed=0))
            if state is None:  # the GPU keyframe's chained state
                state = host((*key_maps, *srv._prev_forest))
            args = (s1.left, s1.right, *state, np.asarray(jax.random.PRNGKey(1)))
            temporal = srv.refine_pipeline(*jax.device_put(args, dev))
            outs[name] = {"keyframe": key_maps, "temporal": host(temporal)}
    worst = 0.0
    for prog in ("keyframe", "temporal"):
        for v, view in enumerate(("left", "right")):
            a, b = outs["gpu"][prog][v], outs["cpu"][prog][v]
            share = float(np.mean(np.abs(a - b) > DIFF_PX))
            worst = max(worst, share)
            print(f"gpu_vs_cpu: {h}x{w}x{d} {prog} program, {view} view: share "
                  f"differing >{DIFF_PX} px = {share:.5f}")
    ok = worst < DIFF_SHARE_MAX
    print(f"gpu_vs_cpu: worst share {worst:.5f} (limit {DIFF_SHARE_MAX}) "
          f"{'pass' if ok else 'FAIL'}")
    return ok


def phase_sgbm_aggregation(h, w, d, seed, gpu, cpu, band: int = 32) -> bool:
    """aggregate_8path on the full-size f32 SGBM volume on the GPU (timed),
    then exact equality with the CPU backend on a band of rows at full
    width and D: the costs are integer-valued f32, so every path sum is
    exact on both."""
    import jax
    import numpy as np

    from stereomatch_tpu.config import SGBMConfig
    from stereomatch_tpu.ops.sgbm import aggregate_8path, sgbm_cost_volume
    from stereomatch_tpu.synthetic import render_scene

    sc = render_scene(seed, h, w, d)
    gray = lambda im: im @ np.array([0.299, 0.587, 0.114], np.float32)  # noqa: E731
    cfg = SGBMConfig(min_disp=0, num_disp=d, block_size=5)
    p1, p2 = (float(p) for p in cfg.resolved_p1p2())
    agg = jax.jit(lambda v: aggregate_8path(v, p1, p2, cfg.num_paths))
    with jax.default_device(gpu):
        vol = jax.jit(lambda a, b: sgbm_cost_volume(a, b, cfg))(gray(sc.left), gray(sc.right))
        ms = 1e3 * _timed(lambda: agg(vol).block_until_ready())
        r0 = h // 2 - band // 2
        vb = np.asarray(vol[r0:r0 + band])
        on_gpu = np.asarray(agg(vb))
    with _on_cpu_uncached(cpu):
        on_cpu = np.asarray(agg(vb))
    mismatched = int(np.sum(on_gpu != on_cpu))
    ok = mismatched == 0 and bool(np.isfinite(on_gpu).all())
    print(f"sgbm_aggregate_8path: {tuple(vol.shape)} f32 {ms:.2f} ms on the GPU "
          f"(median of 5, ended by block_until_ready); band {band}x{w}x{d} "
          f"GPU vs CPU mismatched elements = {mismatched} {'pass' if ok else 'FAIL'}")
    return ok


def phase_tree_scan(forest, seed, gpu, batch: int = 8) -> bool:
    """_segmented_cumsum_mm over the served forest's node-order and Euler
    sequences, against the float64 per-segment cumsum, within the bound
    its docstring derives. The scan's matmul runs at Precision.HIGHEST: at
    default precision this card may take the f32 product in TF32 and miss
    that bound."""
    import jax
    import numpy as np

    from stereomatch_tpu.ops.mst import (
        _segmented_cumsum_mm,
        segmented_cumsum_reference,
        segmented_cumsum_tolerance,
    )

    rng = np.random.default_rng(seed)
    scan = jax.jit(_segmented_cumsum_mm)
    ok = True
    # node order scans subtree costs (>= 0); Euler order scans +v / -v events
    for name, reset_key, maps_key, lo in (
        ("node", "seg_root", "nscan", 0.0), ("euler", "euler_reset", "escan", -0.5)
    ):
        reset = np.asarray(forest[reset_key])
        maps = forest[maps_key]
        x = (rng.random((batch, reset.size)) * 0.5 + lo).astype(np.float32)
        with jax.default_device(gpu):
            xd = jax.device_put(x)
            ms = 1e3 * _timed(lambda: scan(xd, maps).block_until_ready())
            got = np.asarray(scan(xd, maps))
        err = np.abs(got - segmented_cumsum_reference(x, reset))
        ratio = float(np.max(err / segmented_cumsum_tolerance(x, reset)))
        ok &= ratio <= 1.0
        print(f"segmented_cumsum_mm: {name} ({batch}, {reset.size}) "
              f"{int(reset.sum())} segments {ms:.2f} ms on the GPU (median of 5, "
              f"ended by block_until_ready); max err {float(err.max()):.3e} = "
              f"{ratio:.3f} of the bound {'pass' if ratio <= 1.0 else 'FAIL'}")
    return ok


def phase_four_cards(h, w, d, n_frames, seed, devices) -> bool:
    """The stream app's mesh: frames over "frame", rows over "tile"."""
    from functools import partial

    import jax
    import numpy as np

    from stereomatch_tpu.config import (
        CostVolumeConfig,
        CostVolumePipelineConfig,
        GuidedFilterConfig,
    )
    from stereomatch_tpu.models import cost_volume_stereo
    from stereomatch_tpu.parallel import make_mesh
    from stereomatch_tpu.parallel.tiled import tiled_cost_volume_batch
    from stereomatch_tpu.synthetic import render_scene

    if len(devices) < 4:
        raise RuntimeError(f"--cards 4 needs 4 GPUs, JAX found {len(devices)}")
    mesh = make_mesh(n_tile=2, n_frame=2, devices=devices[:4])
    cfg = CostVolumePipelineConfig(
        volume=CostVolumeConfig(min_disp=0, max_disp=d),
        guided=GuidedFilterConfig(slab=16),
    )
    scenes = [render_scene(seed + i, h, w, d) for i in range(n_frames)]
    lb = np.stack([sc.left[..., ::-1] for sc in scenes])  # BGR, as the app feeds
    rb = np.stack([sc.right[..., ::-1] for sc in scenes])
    tiled = tiled_cost_volume_batch(mesh, cfg)
    t = time.perf_counter()
    jax.block_until_ready(tiled(lb, rb))
    print(f"four_cards: 2x2 (frame, tile) mesh compile + first batch "
          f"{time.perf_counter() - t:.1f} s")
    ms = 1e3 * _timed(lambda: jax.block_until_ready(tiled(lb, rb)), reps=3)
    dl, dr = (np.asarray(a) for a in tiled(lb, rb))
    mono = jax.jit(partial(cost_volume_stereo, cfg=cfg))
    worst = worst_fine = 0.0
    with jax.default_device(devices[0]):
        ms1 = 1e3 * _timed(lambda: jax.block_until_ready(mono(lb[0], rb[0])), reps=3)
        for i in range(n_frames):
            out = mono(lb[i], rb[i])
            for a, b in ((dl[i], out.left_disp), (dr[i], out.right_disp)):
                diff = np.abs(a - np.asarray(b))
                worst = max(worst, float(np.mean(diff > TILE_PX)))
                worst_fine = max(worst_fine, float(np.mean(diff > TEST_ATOL)))
    ok = worst <= TILE_SHARE_MAX
    print(f"four_cards: {n_frames} frames {h}x{w} max_disp {d}: tiled batch "
          f"{ms:.1f} ms, single card {ms1:.1f} ms per frame (medians of 3); "
          f"worst share differing >{TILE_PX} px = {worst:.5f} (limit "
          f"{TILE_SHARE_MAX}), >{TEST_ATOL} px = {worst_fine:.5f} "
          f"{'pass' if ok else 'FAIL'}")
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1)
    args = ap.parse_args(argv)
    t0 = time.perf_counter()

    # the GPU-vs-CPU phase needs the CPU backend beside the GPU
    plats = os.environ.get("JAX_PLATFORMS")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"
    import jax

    devices = jax.devices()
    try:
        require_gpu(devices)
    except RuntimeError as e:
        print(e, file=sys.stderr)
        return 1
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", compile_cache_dir(os.environ))
    import stereomatch_tpu  # noqa: F401  fails here when run outside the repo

    gpu = devices[0]
    print(f"card: {card_line()}")
    print(f"jax {jax.__version__}: {len(devices)} x {gpu.device_kind} "
          f"(platform {gpu.platform}); compile cache "
          f"{jax.config.jax_compilation_cache_dir}")
    if args.cards == 4:
        h, w, _ = FULL
        ok = {"four_cards": phase_four_cards(h, w, 127, 4, SEED, devices)}
    else:
        cpu = jax.devices("cpu")[0]
        h, w, d = FULL
        ok_main, forest = phase_main_path(h, w, d, N_FRAMES, RESEED_EVERY, SEED, gpu)
        ok = {"main_path": ok_main}
        ok["tree_scan"] = phase_tree_scan(forest, SEED, gpu)
        ok["sgbm_aggregation"] = phase_sgbm_aggregation(h, w, d, SEED, gpu, cpu)
        ok["gpu_vs_cpu"] = phase_gpu_vs_cpu(*REDUCED, SEED, gpu, cpu)
    print(f"total {time.perf_counter() - t0:.1f} s")
    failed = [k for k, v in ok.items() if not v]
    if failed:
        print(f"FAILED phases: {', '.join(failed)}")
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": gpu.platform, "kind": gpu.device_kind, "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
