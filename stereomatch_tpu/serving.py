"""Production serving layer: AOT-compiled frame pipelines + async executor.

The reference deploys each engine as a per-frame executable main that
re-initializes everything on every invocation (src/stereo_opencv.cpp:93-176
reloads images, reallocates GpuMats and re-runs cv::cuda kernels per call;
src/stereo_Yin.cpp:150-210 re-reads the cost volume and rebuilds the
segment forest per frame). An accelerator serving path wants the
opposite shape:

- compile ONCE ahead of time, from shape specs, before any frame exists
  (`jax.jit(...).lower(...).compile()` on `jax.ShapeDtypeStruct`s), so
  the first request pays zero compile latency;
- keep the executable + its cost/memory analysis around as a first-class
  object (capacity planning: FLOPs, bytes accessed, peak HBM);
- exploit XLA's async dispatch for the steady state: enqueue frame N+1's
  host->device transfer and computation while frame N is still on the
  device, and only materialize results on collect. With the fused
  SGBM+3DMST frame program (models/sgbm_mst.py) the whole north-star
  composition is one executable, so the stream is: upload pair ->
  one program -> download maps, double-buffered.

No new math lives here — this wraps the frame programs the engines
already expose.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from .config import MSTConfig, SGBMConfig

__all__ = [
    "CompiledPipeline",
    "StagedPipeline",
    "StereoStreamServer",
    "VideoStreamServer",
    "compile_sgbm_mst_server",
    "compile_mst_video_server",
]


def _spec_leaf(x) -> jax.ShapeDtypeStruct:
    if isinstance(x, jax.ShapeDtypeStruct):
        return x
    a = jnp.asarray(x) if not hasattr(x, "shape") else x
    return jax.ShapeDtypeStruct(a.shape, a.dtype)


def _spec(x):
    """Spec for one example argument — which may be a PYTREE of arrays
    (e.g. the device-forest dict chained between video executables)."""
    return jax.tree_util.tree_map(
        _spec_leaf, x,
        is_leaf=lambda v: isinstance(v, jax.ShapeDtypeStruct),
    )


def _check_shapes(args, specs) -> None:
    for a, s in zip(args, specs):
        for al, sl in zip(jax.tree_util.tree_leaves(a),
                          jax.tree_util.tree_leaves(s)):
            if tuple(al.shape) != tuple(sl.shape):
                raise ValueError(
                    f"input shape {tuple(al.shape)} != compiled spec "
                    f"{tuple(sl.shape)}; serving executables are "
                    f"fixed-shape — build one per resolution"
                )


class CompiledPipeline:
    """A frame function AOT-compiled for fixed shapes.

    `example_args` may be real arrays OR `jax.ShapeDtypeStruct`s — the
    serving path compiles from specs alone, before any input exists.
    The XLA executable's own cost model is exposed for capacity
    planning (`flops`, `bytes_accessed`, `peak_hbm_bytes`).
    """

    def __init__(
        self,
        fn: Callable,
        example_args: Sequence[Any],
        donate_argnums: Sequence[int] = (),
    ):
        self._specs = tuple(_spec(a) for a in example_args)
        jitted = jax.jit(fn, donate_argnums=tuple(donate_argnums))
        self._lowered = jitted.lower(*self._specs)
        self._compiled = self._lowered.compile()

    @property
    def in_specs(self) -> tuple[jax.ShapeDtypeStruct, ...]:
        return self._specs

    def _analysis(self) -> dict:
        try:
            ca = self._compiled.cost_analysis()
            # older jax returns a per-device list
            if isinstance(ca, (list, tuple)):
                ca = ca[0] if ca else {}
            return dict(ca) if ca else {}
        except Exception:
            return {}

    @property
    def flops(self) -> float:
        return float(self._analysis().get("flops", 0.0))

    @property
    def bytes_accessed(self) -> float:
        return float(self._analysis().get("bytes accessed", 0.0))

    @property
    def peak_hbm_bytes(self) -> int:
        try:
            ma = self._compiled.memory_analysis()
            return int(
                getattr(ma, "temp_size_in_bytes", 0)
                + getattr(ma, "argument_size_in_bytes", 0)
                + getattr(ma, "output_size_in_bytes", 0)
            )
        except Exception:
            return 0

    @property
    def output_hbm_bytes(self) -> int:
        try:
            ma = self._compiled.memory_analysis()
            return int(getattr(ma, "output_size_in_bytes", 0))
        except Exception:
            return 0

    def __call__(self, *args):
        _check_shapes(args, self._specs)
        return self._compiled(*args)

    def serialize(self) -> bytes:
        """Serialized XLA executable + input specs: a restarted process
        `CompiledPipeline.deserialize()`s and serves without recompiling
        the full-size frame programs. Executables are backend- and
        topology-specific — load on the same device type that compiled
        them."""
        import pickle

        from jax.experimental import serialize_executable as _se

        return pickle.dumps((_se.serialize(self._compiled), self._specs))

    @classmethod
    def deserialize(cls, data: bytes) -> "CompiledPipeline":
        import pickle

        from jax.experimental import serialize_executable as _se

        payload, specs = pickle.loads(data)
        self = cls.__new__(cls)
        self._specs = specs
        self._lowered = None
        # single-device executables: without explicit execution_devices,
        # deserialize_and_load maps onto ALL local devices and the load
        # then expects N-sharded args (seen on the 8-virtual-device CPU
        # test mesh)
        self._compiled = _se.deserialize_and_load(
            *payload, execution_devices=jax.devices()[:1]
        )
        return self


class StagedPipeline:
    """A frame function split into a CHAIN of smaller AOT executables
    handed device arrays (no host sync between stages — XLA dispatch is
    async, so the chain enqueues like one program).

    Same interface as CompiledPipeline, so the stream executors accept
    either. Use it when one monolithic frame program is too big for the
    worker (program-size or memory limits), or to time the stages
    apart. Cost analyses sum over stages; peak HBM is
    the max over stages of (stage peak + earlier stages' chained
    outputs that may still be live).
    """

    def __init__(self, stages: Sequence[CompiledPipeline],
                 driver: Callable[..., Any],
                 in_specs: Sequence[jax.ShapeDtypeStruct]):
        self.stages = tuple(stages)
        self._driver = driver
        self._specs = tuple(in_specs)

    @property
    def in_specs(self) -> tuple[jax.ShapeDtypeStruct, ...]:
        return self._specs

    @property
    def flops(self) -> float:
        return float(sum(s.flops for s in self.stages))

    @property
    def bytes_accessed(self) -> float:
        return float(sum(s.bytes_accessed for s in self.stages))

    @property
    def peak_hbm_bytes(self) -> int:
        """Max over stages of (that stage's peak + every EARLIER stage's
        outputs): chained device arrays from earlier stages may still be
        live while a later stage runs. A whole-chain sum (the previous
        bound) double-counted inputs fed to several stages and every
        chained volume — far looser than this for capacity planning."""
        best, live = 0, 0
        for s in self.stages:
            best = max(best, s.peak_hbm_bytes + live)
            live += s.output_hbm_bytes
        return int(best)

    def __call__(self, *args):
        _check_shapes(args, self._specs)
        return self._driver(*args)


def _cached_pipeline(fn: Callable, example_args: Sequence[Any],
                     cache_dir: str | None, tag: str,
                     key_material: str = "") -> CompiledPipeline:
    """Build a CompiledPipeline, round-tripping through an on-disk
    executable cache when `cache_dir` is given: the cache key covers the
    stage tag, `key_material` (pass repr(cfg) + every static knob the
    specs don't encode), jax version, backend and the full input-spec
    pytree, so a config/shape change misses cleanly. Corrupt or
    incompatible entries fall back to a fresh compile (and overwrite)."""
    import hashlib
    import os

    specs = tuple(_spec(a) for a in example_args)
    path = None
    if cache_dir:
        key = hashlib.sha256(
            repr((tag, key_material, jax.__version__,
                  jax.default_backend(), specs)).encode()).hexdigest()[:16]
        path = os.path.join(cache_dir, f"{tag}-{key}.jaxexec")
        if os.path.exists(path):
            try:
                with open(path, "rb") as f:
                    pipe = CompiledPipeline.deserialize(f.read())
                # validate with one zero-input run: XLA:CPU's AOT loader
                # is broken on some hosts (machine-feature mismatch ->
                # "Function ... not found" at execute time), and a
                # serving executor must never discover that mid-stream.
                # One warm-up frame is cheap next to the recompile it
                # replaces — and servers want a warm-up anyway.
                zeros = [
                    jax.tree_util.tree_map(
                        lambda s: jnp.zeros(s.shape, s.dtype), sp,
                        is_leaf=lambda v: isinstance(v, jax.ShapeDtypeStruct),
                    )
                    for sp in pipe.in_specs
                ]
                jax.block_until_ready(pipe(*zeros))
                return pipe
            except Exception:
                pass  # stale/incompatible/unloadable: recompile below
    pipe = CompiledPipeline(fn, specs)
    if path:
        try:
            os.makedirs(cache_dir, exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(pipe.serialize())
            os.replace(tmp, path)
        except Exception:
            pass  # cache is best-effort
    return pipe


def _staged_vol_pipe(h: int, w: int, d: int,
                     out_dtype: str = "float32",
                     guided: bool = True,
                     cache_dir: str | None = None) -> CompiledPipeline:
    """Stage executable: BGR pair -> (left, right) cost volumes.

    `out_dtype` = cfg.volume_dtype: casting at THIS stage's output halves
    the chained bytes handed to the refine stages (~1.26 GB -> 0.63 GB
    per view at 1280x960x128 bf16) — identical math to casting inside
    each refine stage (which re-casts are no-ops)."""
    from .models.costvolume import builtin_cost_volumes

    img = jax.ShapeDtypeStruct((h, w, 3), jnp.float32)

    def vols(lb, rb):
        vl, vr = builtin_cost_volumes(lb[..., ::-1], rb[..., ::-1], d,
                                      guided=guided)
        return vl.astype(out_dtype), vr.astype(out_dtype)

    return _cached_pipeline(vols, (img, img), cache_dir, "vol",
                            f"{d}_{out_dtype}_{guided}")


def _staged_seed_pipe(h: int, w: int, sgbm_cfg: SGBMConfig,
                      right_seed: str,
                      cache_dir: str | None = None) -> CompiledPipeline:
    """Stage executable: BGR pair -> (left, right) SGBM seed maps."""
    from .models.sgbm_mst import _gray_from_bgr, _seed_pair

    img = jax.ShapeDtypeStruct((h, w, 3), jnp.float32)

    def seeds(lb, rb):
        return _seed_pair(
            _gray_from_bgr(lb), _gray_from_bgr(rb), sgbm_cfg, right_seed
        )

    return _cached_pipeline(seeds, (img, img), cache_dir, "seed",
                            repr(sgbm_cfg) + right_seed)


def _staged_refine_pipe(cfg: MSTConfig, h: int, w: int, d: int, tmax: int,
                        adj_cap: int, iterations: int, refine_start,
                        max_neighbors: int, view_idx: int,
                        clip_span: float | None = None,
                        cache_dir: str | None = None) -> CompiledPipeline:
    """Stage executable: one view's forest + seeded label refinement.

    Splits the frame key exactly like _sgbm_mst_frame_fused (left =
    split[0], right = split[1]) so the staged chain reproduces the fused
    program's RNG stream. `clip_span` mirrors the video refine program's
    clip of the previous frame's maps. The volume arrives already cast to
    cfg.volume_dtype (the volume stage casts at its output)."""
    from .models.sgbm_mst import _fused_refine_view

    img = jax.ShapeDtypeStruct((h, w, 3), jnp.float32)
    vol = jax.ShapeDtypeStruct((h, w, d), jnp.dtype(cfg.volume_dtype))
    dsp = jax.ShapeDtypeStruct((h, w), jnp.float32)
    key = jax.ShapeDtypeStruct((2,), jnp.uint32)

    def f(bgr, v, sd, k):
        if clip_span is not None:
            sd = jnp.clip(sd, 0.0, clip_span)
        return _fused_refine_view(
            bgr, v, sd, jax.random.split(k)[view_idx], cfg, h, w,
            tmax, adj_cap, iterations, refine_start, max_neighbors,
        )

    return _cached_pipeline(
        f, (img, vol, dsp, key), cache_dir, f"refine{view_idx}",
        f"{repr(cfg)}_{tmax}_{adj_cap}_{iterations}_{refine_start}_"
        f"{max_neighbors}_{clip_span}")


def _staged_forest_pipe(cfg: MSTConfig, h: int, w: int, tmax: int,
                        adj_cap: int,
                        cache_dir: str | None = None) -> CompiledPipeline:
    """Stage executable: one view's BGR image -> device-forest pytree
    (build_forest_device raw dict) — split out of the refine stage so
    the video server can chain a keyframe's forests into later temporal
    frames (reuse_forest)."""
    from .models.sgbm_mst import _view_forest

    img = jax.ShapeDtypeStruct((h, w, 3), jnp.float32)
    return _cached_pipeline(
        lambda b: _view_forest(b, cfg, tmax, adj_cap), (img,),
        cache_dir, "forest", f"{repr(cfg)}_{tmax}_{adj_cap}")


def _staged_refine_core_pipe(cfg: MSTConfig, h: int, w: int, d: int,
                             tmax: int, iterations: int, refine_start,
                             max_neighbors: int, view_idx: int,
                             forest_spec,
                             clip_span: float | None = None,
                             cache_dir: str | None = None
                             ) -> CompiledPipeline:
    """Stage executable: seeded label refinement on an ALREADY-BUILT
    forest (volume, seed map, forest pytree, frame key -> disparity).
    Same RNG stream as _staged_refine_pipe (key split by view)."""
    from .models.sgbm_mst import _refine_view_given_forest

    vol = jax.ShapeDtypeStruct((h, w, d), jnp.dtype(cfg.volume_dtype))
    dsp = jax.ShapeDtypeStruct((h, w), jnp.float32)
    key = jax.ShapeDtypeStruct((2,), jnp.uint32)

    def f(v, sd, raw, k):
        if clip_span is not None:
            sd = jnp.clip(sd, 0.0, clip_span)
        return _refine_view_given_forest(
            raw, v, sd, jax.random.split(k)[view_idx], cfg, h, w, tmax,
            iterations, refine_start, max_neighbors,
        )

    return _cached_pipeline(
        f, (vol, dsp, forest_spec, key), cache_dir, f"refcore{view_idx}",
        f"{repr(cfg)}_{tmax}_{iterations}_{refine_start}_"
        f"{max_neighbors}_{clip_span}")


@dataclass
class _Pending:
    ticket: int
    outputs: Any
    replay: Callable[[], Any] | None = None  # host-side re-execution
    stat: Any = None  # device scalar future (LR-valid fraction)
    is_key: bool = False  # video executor: keyframe vs temporal frame


class StereoStreamServer:
    """Async double-buffered executor over one compiled frame program.

    `submit()` enqueues the host->device upload and the frame program and
    returns a ticket IMMEDIATELY (XLA dispatch is async); `collect()`
    blocks only on that frame's outputs and returns numpy arrays. With
    `capacity` >= 2 the upload + compute of frame N+1 overlap the compute
    of frame N — the steady-state rate is max(upload, compute), not
    their sum. Submitting beyond `capacity` first collects the oldest
    frame (backpressure), bounding device memory to `capacity` frames.

    Failure recovery (`retries` > 0): a worker that restarts under
    preemption surfaces as an exception when a frame's outputs are
    materialized and LOSES every live device buffer. With
    retries enabled the executor keeps a HOST copy of each in-flight
    frame's inputs and, when materialization fails, re-uploads and
    re-runs that frame up to `retries` times (`retry_backoff_s` between
    attempts — set it to the fleet's worker-restart time in real
    deployments; `failures` counts recovered attempts for
    observability). The reference has no failure story at all
    (SURVEY §5: system() return codes checked only to early-return).
    """

    def __init__(
        self,
        pipeline: CompiledPipeline,
        capacity: int = 2,
        retries: int = 0,
        retry_backoff_s: float = 0.0,
    ):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.pipeline = pipeline
        self.capacity = capacity
        self.retries = retries
        self.retry_backoff_s = retry_backoff_s
        self.failures = 0
        # subclasses set this to force replay-closure capture even with
        # retries=0 (the video executor's quality-triggered reseed needs
        # a keyframe replay path independent of failure recovery)
        self._always_replay = False
        self._queue: deque[_Pending] = deque()
        self._next = 0
        self._done: dict[int, Any] = {}

    def submit(
        self,
        *frame_args,
        _pipeline: CompiledPipeline | None = None,
        _replay_args: Sequence[Any] | None = None,
        _post: Callable[[Any], Any] | None = None,
        _replay_post: Callable[[Any], Any] | None = None,
    ) -> int:
        """`_post` transforms the pipeline's output before it is queued
        (the reuse-forest video server strips + captures the keyframe's
        forest state); `_replay_post` does the same for the REPLAY path's
        output — they differ when replay routes through a different
        pipeline than the direct call (_replay_args)."""
        if len(self._queue) >= self.capacity:
            self._finish(self._queue.popleft())
        replay = None
        _up = lambda a: jax.tree_util.tree_map(  # noqa: E731  pytree args
            lambda x: x if isinstance(x, jax.Array)
            else jax.device_put(jnp.asarray(x)), a)
        if self.retries or (self._always_replay and _replay_args is not None):
            # Host snapshot for replay after device-state loss. When
            # `_replay_args` is given (the video executor: a refine
            # frame's chained device seeds die with the worker), replay
            # routes those args through the PRIMARY pipeline instead.
            src = frame_args if _replay_args is None else _replay_args
            target = (_pipeline or self.pipeline) if _replay_args is None \
                else self.pipeline
            rp = _replay_post if _replay_args is not None else \
                (_replay_post or _post)
            host = tuple(
                jax.tree_util.tree_map(np.asarray, a) for a in src
            )

            def replay(host=host, target=target, rp=rp):
                out = target(*[_up(a) for a in host])
                return rp(out) if rp else out

        try:
            dev = [_up(a) for a in frame_args]
            out = (_pipeline or self.pipeline)(*dev)
            if _post:
                out = _post(out)
        except Exception:
            # dispatch itself can raise eagerly when an INPUT buffer died
            # with the worker (chained video seeds); recover in place
            if replay is None:
                raise
            self.failures += 1
            out = replay()
        ticket = self._next
        self._next += 1
        self._queue.append(_Pending(ticket, out, replay))
        return ticket

    def _finish(self, p: _Pending) -> None:
        try:
            self._done[p.ticket] = jax.tree_util.tree_map(np.asarray, p.outputs)
            return
        except Exception:
            if not (self.retries and p.replay):
                raise
        import time as _time

        err: Exception | None = None
        for _attempt in range(self.retries):
            self.failures += 1
            if self.retry_backoff_s:  # the worker is restarting right now
                _time.sleep(self.retry_backoff_s)
            try:
                out = p.replay()
                self._done[p.ticket] = jax.tree_util.tree_map(np.asarray, out)
                return
            except Exception as e:  # worker may still be restarting
                err = e
        raise err

    def collect(self, ticket: int):
        """Block until `ticket`'s frame is done; returns numpy pytree."""
        while ticket not in self._done:
            if not self._queue:
                raise KeyError(f"unknown or already-collected ticket {ticket}")
            self._finish(self._queue.popleft())
        return self._done.pop(ticket)

    def drain(self) -> list[Any]:
        """Collect every outstanding frame, in submission order."""
        tickets = [p.ticket for p in self._queue] + sorted(self._done)
        return [self.collect(t) for t in sorted(set(tickets))]


def compile_sgbm_mst_server(
    h: int,
    w: int,
    cfg: MSTConfig | None = None,
    sgbm_cfg: SGBMConfig | None = None,
    fine_iterations: int = 4,
    refine_start: float | None = 2.0,
    max_neighbors: int = 2,
    right_seed: str = "disp2",
    capacity: int = 2,
    retries: int = 0,
    retry_backoff_s: float = 0.0,
    staged: bool = False,
    cache_dir: str | None = None,
    volume_guided: bool = True,
) -> StereoStreamServer:
    """AOT-compile the production north-star pipeline for an HxW stream.

    The frame program is the fused SGBM-seeded 3DMST composition
    (models/sgbm_mst.py::_sgbm_mst_frame_fused) with the on-device
    adgrad+guided cost-volume build in front: BGR pair in, (left, right)
    disparity maps out, one XLA executable, zero per-frame host work.
    Config defaults to `config.production_mst_config` (PARITY.md
    "Production seeded config"). Frames are keyed by submission index so
    the RNG stream is reproducible per frame.

    `staged=True` compiles the SAME composition as a chain of four
    smaller executables (cost volumes / SGBM seeds / per-view refine)
    handed device arrays — identical math and RNG stream, sized for
    workers that cannot execute the monolithic frame program (see
    StagedPipeline). Output parity with the fused server is tested
    (tests/test_serving.py).

    `cache_dir` enables the on-disk EXECUTABLE cache: every pipeline
    this builds is serialized there (jax.experimental
    .serialize_executable), and a restarted process — the recovery
    story — loads it instead of recompiling the full-size programs.
    Keys cover config, shapes, jax version and backend; stale entries
    recompile cleanly.
    """
    from .config import production_mst_config
    from .models.mst import _fused_capacities
    from .models.sgbm_mst import _default_sgbm_cfg, _sgbm_mst_frame_fused
    from .models.costvolume import builtin_cost_volumes

    if cfg is None:
        cfg = production_mst_config(128, forest_backend="device")
    if sgbm_cfg is None:
        sgbm_cfg = _default_sgbm_cfg(cfg)
    d = cfg.max_disp
    tmax, adj_cap = _fused_capacities(h, w, cfg)

    img = jax.ShapeDtypeStruct((h, w, 3), jnp.float32)
    key = jax.ShapeDtypeStruct((2,), jnp.uint32)
    if staged:
        vol_pipe = _staged_vol_pipe(h, w, d, cfg.volume_dtype,
                                    guided=volume_guided,
                                    cache_dir=cache_dir)
        seed_pipe = _staged_seed_pipe(h, w, sgbm_cfg, right_seed,
                                      cache_dir=cache_dir)
        ref_l, ref_r = (
            _staged_refine_pipe(
                cfg, h, w, d, tmax, adj_cap, fine_iterations,
                refine_start, max_neighbors, i, cache_dir=cache_dir,
            )
            for i in (0, 1)
        )

        def driver(left_bgr, right_bgr, k):
            vl, vr = vol_pipe(left_bgr, right_bgr)
            dl, dr = seed_pipe(left_bgr, right_bgr)
            return (
                ref_l(left_bgr, vl, dl, k),
                ref_r(right_bgr, vr, dr, k),
            )

        pipe: CompiledPipeline | StagedPipeline = StagedPipeline(
            (vol_pipe, seed_pipe, ref_l, ref_r), driver, (img, img, key)
        )
    else:
        def frame(left_bgr, right_bgr, key):
            vl, vr = builtin_cost_volumes(
                left_bgr[..., ::-1], right_bgr[..., ::-1], d,
                guided=volume_guided,
            )
            return _sgbm_mst_frame_fused(
                left_bgr, right_bgr, vl, vr, key, cfg, sgbm_cfg,
                fine_iterations, refine_start, max_neighbors, h, w,
                tmax, adj_cap, right_seed,
            )

        pipe = _cached_pipeline(
            frame, (img, img, key), cache_dir, "sgbm_mst_frame",
            f"{repr(cfg)}_{repr(sgbm_cfg)}_{fine_iterations}_"
            f"{refine_start}_{max_neighbors}_{right_seed}_{tmax}_{adj_cap}")
    server = StereoStreamServer(pipe, capacity=capacity, retries=retries,
                                retry_backoff_s=retry_backoff_s)

    def submit_pair(left_bgr, right_bgr, seed: int | None = None):
        s = server._next if seed is None else seed
        return server.submit(left_bgr, right_bgr, jax.random.PRNGKey(s))

    server.submit_pair = submit_pair  # type: ignore[attr-defined]
    return server


def _make_lr_stat(max_disp: int) -> Callable[[Any, Any], Any]:
    """Jitted LR-valid-fraction stat for scene-cut detection: one HxW
    gather + compare over the frame's output maps — negligible next to
    any volume pass, and dispatched asynchronously behind the frame
    program (the scalar future materializes at _finish)."""
    from .ops.postprocess import lr_consistency

    @jax.jit
    def stat(disp_l, disp_r):
        _, valid = lr_consistency(disp_l, disp_r, float(max_disp),
                                  fill=False)
        return jnp.mean(valid.astype(jnp.float32))

    return stat


class VideoStreamServer(StereoStreamServer):
    """Stateful video executor: frame N's refined disparity maps seed
    frame N+1's plane labels ON DEVICE.

    The seed dependency is a jax.Array future, so chaining frames never
    syncs the host — XLA schedules frame N+1's refine program behind
    frame N's outputs and the async upload/compute overlap of the base
    executor is preserved. Keyframes (frame 0 and, if `reseed_every` is
    set, every `reseed_every` frames SINCE the last keyframe — the
    cadence counter rephases on `reset()`, so a scene cut restarts it)
    run the full SGBM-seeded program (`self.pipeline`); steady-state
    frames run the refine-only program, dropping the whole SGBM stage
    from the per-frame byte budget
    (models/sgbm_mst.py::_mst_refine_frame_fused).

    Seeding semantics (deliberate, GT-sequence-gated): the chained
    temporal state is the RAW dense pre-LR-check map pair straight out of
    the fused frame program — keeping the chain on-device with zero host
    sync. This differs from the offline `sgbm_mst_video` composition,
    which seeds the left view from LR-checked + nearest-valid-filled
    maps; the dense-seeded serving path is gated on the same absolute-GT
    sequence (tests/test_serving.py::
    test_video_server_refine_path_absolute_gt_sequence)."""

    def __init__(
        self,
        keyframe_pipeline: CompiledPipeline,
        refine_pipeline: CompiledPipeline,
        capacity: int = 2,
        reseed_every: int = 0,
        retries: int = 0,
        retry_backoff_s: float = 0.0,
        reuse_forest: bool = False,
        scene_cut_ratio: float = 0.0,
        lr_stat: Callable[[Any, Any], Any] | None = None,
    ):
        super().__init__(keyframe_pipeline, capacity=capacity,
                         retries=retries, retry_backoff_s=retry_backoff_s)
        self.refine_pipeline = refine_pipeline
        self.reseed_every = reseed_every
        self.reuse_forest = reuse_forest
        # Quality-triggered reseed (scene-cut detection): a temporal
        # frame whose LR-valid fraction falls below scene_cut_ratio x
        # the last keyframe's fraction is REPLAYED through the keyframe
        # pipeline — the temporal ladder (temporal_refine_start px) only
        # covers video-scale motion, so a hard cut leaves the seed
        # pointing at the wrong scene (measured on the real FLIR rig:
        # frames 000020->000040 are a large scene jump and the temporal
        # frame's bad2 vs the SGBM oracle collapses 3%->35%; with the
        # detector it recovers to keyframe quality). 0 disables.
        self.scene_cut_ratio = scene_cut_ratio
        self._lr_stat = lr_stat
        self._always_replay = bool(scene_cut_ratio)
        self.scene_cuts = 0  # observability: quality-triggered reseeds
        self._key_frac: float | None = None
        self._prev_ticket: int | None = None
        self._prev: Any = None
        self._prev_forest: Any = None  # (raw_l, raw_r) device pytrees
        self._since_key = 0  # frames submitted since last keyframe, incl. it

    def _capture_forest(self, out):
        """Keyframe-output post: stash the forest pytrees as chained
        device state and hand only the disparity pair downstream (they
        must NOT reach _finish — materializing ~100 MB of forest arrays
        to host every keyframe would throttle collect())."""
        disp_l, disp_r, raw_l, raw_r = out
        self._prev_forest = (raw_l, raw_r)
        return (disp_l, disp_r)

    def submit_pair(self, left_bgr, right_bgr, seed: int | None = None) -> int:
        i = self._next
        key = jax.random.PRNGKey(i if seed is None else seed)
        keyframe = self._prev is None or (
            self.reseed_every and self._since_key >= self.reseed_every
        )
        post = self._capture_forest if self.reuse_forest else None
        if keyframe:
            t = self.submit(left_bgr, right_bgr, key, _post=post)
            self._since_key = 1
        else:
            # failure replay re-runs this frame as a KEYFRAME: a worker
            # restart loses the chained device seeds (and forests), so
            # the honest recovery is to re-key the temporal chain at
            # this frame (keyframes are the highest-quality path; only
            # cost is one SGBM pass)
            fargs = self._prev_forest if self.reuse_forest else ()
            t = self.submit(
                left_bgr, right_bgr, *self._prev, *fargs, key,
                _pipeline=self.refine_pipeline,
                _replay_args=(left_bgr, right_bgr, key),
                _replay_post=post,
            )
            self._since_key += 1
        p = self._queue[-1]
        p.is_key = keyframe
        if self.scene_cut_ratio and self._lr_stat is not None:
            # async device scalar chained on the frame's outputs; the
            # host never syncs here (materialized at _finish)
            p.stat = self._lr_stat(p.outputs[0], p.outputs[1])
        self._prev = p.outputs  # (disp_l, disp_r) device arrays
        self._prev_ticket = t
        return t

    def _finish(self, p) -> None:
        super()._finish(p)
        if p.stat is None:
            return
        try:
            frac = float(p.stat)
        except Exception:
            # the stat's buffers died with a worker crash that super()
            # already recovered via replay — nothing to grade
            return
        if p.is_key:
            self._key_frac = frac
            return
        ref = self._key_frac
        if not (ref and p.replay is not None
                and frac < self.scene_cut_ratio * ref):
            return
        # scene cut: the temporal seed belongs to a different scene —
        # replay this frame through the keyframe pipeline (fresh SGBM
        # seed + fresh forests; _capture_forest re-chains them)
        self.scene_cuts += 1
        out = p.replay()
        self._done[p.ticket] = jax.tree_util.tree_map(np.asarray, out)
        if self._prev_ticket == p.ticket:
            # no newer frame submitted yet: re-key the temporal chain at
            # this frame's keyframe-quality output and rephase cadence
            self._prev = out
            self._since_key = 1
        if self._lr_stat is not None:
            self._key_frac = float(self._lr_stat(out[0], out[1]))

    def reset(self) -> None:
        """Drop the temporal state (scene cut): the next frame reseeds
        and the keyframe cadence rephases to it."""
        self._prev = None
        self._prev_forest = None
        self._since_key = 0
        self._key_frac = None
        self._prev_ticket = None


def compile_mst_video_server(
    h: int,
    w: int,
    cfg: MSTConfig | None = None,
    sgbm_cfg: SGBMConfig | None = None,
    fine_iterations: int = 4,
    temporal_iterations: int | None = 2,
    refine_start: float | None = 2.0,
    temporal_refine_start: float | None = 4.0,
    max_neighbors: int = 2,
    right_seed: str = "disp2",
    reseed_every: int = 0,
    capacity: int = 2,
    retries: int = 0,
    retry_backoff_s: float = 0.0,
    staged: bool = False,
    reuse_forest: bool = False,
    cache_dir: str | None = None,
    volume_guided: bool = True,
    scene_cut_ratio: float = 0.0,
) -> VideoStreamServer:
    """AOT-compile the VIDEO serving pair for an HxW stream: the
    SGBM-seeded keyframe program plus the temporal refine-only program
    (previous frame's maps in, refined maps out), both from shape specs
    alone. Steady-state per-frame work = cost-volume build + forest +
    `temporal_iterations` truncated-ladder refinements — no SGBM pass.

    The two programs take SEPARATE ladder entries (ADVICE r3): the
    keyframe keeps `refine_start` (2.0, the single-frame seeded recipe —
    a fresh SGBM seed is only subpixel-wrong) while the refine program
    uses `temporal_refine_start` (default 4.0, the measured video
    recipe: the ladder must cover the expected inter-frame motion in
    pixels — rs=2 at 3 px drift doubled bad2 on the GT sequence).
    temporal_iterations likewise defaults to the measured recipe (2:
    better than 4 on the GT sequence — tests/test_mst_video.py).

    `staged=True` compiles both frame programs as chains of smaller
    executables (see StagedPipeline / compile_sgbm_mst_server): the
    keyframe chain is volumes/seeds/per-view refine; the temporal chain
    is volumes/per-view refine, SHARING the keyframe's volume-build
    executable. Identical math and RNG streams to the fused pair.

    `reuse_forest=True` takes the device-forest BUILD off the
    steady-state critical path (round-5; the reference rebuilds its
    segment forest from scratch every frame, src/stereo_Yin.cpp:207 ->
    src/Stereo3DMST.cpp:213-543): the keyframe program additionally
    outputs both views' forest pytrees, the server chains them on
    device, and temporal frames refine on the KEYFRAME's (stale)
    forests — segmentation drifts slowly, so per-frame work drops to
    volume build + refine iterations only. Quality is gated on the
    moving GT sequence through the real executables
    (tests/test_serving.py); pair with `reseed_every` to bound forest
    staleness. RNG streams are unchanged.

    `scene_cut_ratio` (0 disables) arms quality-triggered reseed: every
    frame's LR-valid fraction is computed ON DEVICE (an HxW-cheap jitted
    stat chained on the frame outputs — no host sync at submit); a
    temporal frame whose fraction falls below `scene_cut_ratio` x the
    last keyframe's is replayed through the keyframe pipeline at
    collect time (`scene_cuts` counts them). This is the production
    guard for hard cuts the temporal ladder cannot absorb — see
    VideoStreamServer.__init__ for the measured FLIR motivation.
    """
    from .config import production_mst_config
    from .models.mst import _fused_capacities
    from .models.sgbm_mst import (
        _default_sgbm_cfg,
        _mst_refine_frame_fused,
        _sgbm_mst_frame_fused,
    )
    from .models.costvolume import builtin_cost_volumes

    if cfg is None:
        cfg = production_mst_config(128, forest_backend="device")
    if sgbm_cfg is None:
        sgbm_cfg = _default_sgbm_cfg(cfg)
    d = cfg.max_disp
    ti = fine_iterations if temporal_iterations is None else temporal_iterations
    trs = refine_start if temporal_refine_start is None else temporal_refine_start
    tmax, adj_cap = _fused_capacities(h, w, cfg)
    span = float(d - 1)

    img = jax.ShapeDtypeStruct((h, w, 3), jnp.float32)
    dsp = jax.ShapeDtypeStruct((h, w), jnp.float32)
    key = jax.ShapeDtypeStruct((2,), jnp.uint32)
    if reuse_forest:
        from .models.sgbm_mst import (
            _gray_from_bgr,
            _refine_view_given_forest,
            _seed_pair,
            _view_forest,
        )

        forest_spec = jax.eval_shape(
            lambda b: _view_forest(b, cfg, tmax, adj_cap), img
        )
        if staged:
            vol_pipe = _staged_vol_pipe(h, w, d, cfg.volume_dtype,
                                    guided=volume_guided,
                                    cache_dir=cache_dir)
            seed_pipe = _staged_seed_pipe(h, w, sgbm_cfg, right_seed,
                                      cache_dir=cache_dir)
            forest_pipe = _staged_forest_pipe(cfg, h, w, tmax, adj_cap,
                                              cache_dir=cache_dir)
            kc_l, kc_r = (
                _staged_refine_core_pipe(
                    cfg, h, w, d, tmax, fine_iterations, refine_start,
                    max_neighbors, i, forest_spec, cache_dir=cache_dir,
                )
                for i in (0, 1)
            )
            rc_l, rc_r = (
                _staged_refine_core_pipe(
                    cfg, h, w, d, tmax, ti, trs, max_neighbors, i,
                    forest_spec, clip_span=span, cache_dir=cache_dir,
                )
                for i in (0, 1)
            )

            def kf_driver(lb, rb, k):
                vl, vr = vol_pipe(lb, rb)
                dl, dr = seed_pipe(lb, rb)
                fl, fr = forest_pipe(lb), forest_pipe(rb)
                return (kc_l(vl, dl, fl, k), kc_r(vr, dr, fr, k), fl, fr)

            def rf_driver(lb, rb, pdl, pdr, fl, fr, k):
                vl, vr = vol_pipe(lb, rb)
                return rc_l(vl, pdl, fl, k), rc_r(vr, pdr, fr, k)

            key_pipe: CompiledPipeline | StagedPipeline = StagedPipeline(
                (vol_pipe, seed_pipe, forest_pipe, kc_l, kc_r),
                kf_driver, (img, img, key),
            )
            ref_pipe: CompiledPipeline | StagedPipeline = StagedPipeline(
                (vol_pipe, rc_l, rc_r), rf_driver,
                (img, img, dsp, dsp, forest_spec, forest_spec, key),
            )
        else:
            def keyframe_rf(left_bgr, right_bgr, k):
                vl, vr = builtin_cost_volumes(
                    left_bgr[..., ::-1], right_bgr[..., ::-1], d,
                    guided=volume_guided,
                )
                sl, sr = _seed_pair(
                    _gray_from_bgr(left_bgr), _gray_from_bgr(right_bgr),
                    sgbm_cfg, right_seed,
                )
                kl, kr = jax.random.split(k)
                fl = _view_forest(left_bgr, cfg, tmax, adj_cap)
                fr = _view_forest(right_bgr, cfg, tmax, adj_cap)
                dl = _refine_view_given_forest(
                    fl, vl, sl, kl, cfg, h, w, tmax, fine_iterations,
                    refine_start, max_neighbors,
                )
                dr = _refine_view_given_forest(
                    fr, vr, sr, kr, cfg, h, w, tmax, fine_iterations,
                    refine_start, max_neighbors,
                )
                return dl, dr, fl, fr

            def refine_rf(left_bgr, right_bgr, pdl, pdr, fl, fr, k):
                vl, vr = builtin_cost_volumes(
                    left_bgr[..., ::-1], right_bgr[..., ::-1], d,
                    guided=volume_guided,
                )
                kl, kr = jax.random.split(k)
                dl = _refine_view_given_forest(
                    fl, vl, jnp.clip(pdl, 0.0, span), kl, cfg, h, w,
                    tmax, ti, trs, max_neighbors,
                )
                dr = _refine_view_given_forest(
                    fr, vr, jnp.clip(pdr, 0.0, span), kr, cfg, h, w,
                    tmax, ti, trs, max_neighbors,
                )
                return dl, dr

            _km = (f"{repr(cfg)}_{repr(sgbm_cfg)}_{fine_iterations}_"
                   f"{refine_start}_{max_neighbors}_{right_seed}_"
                   f"{tmax}_{adj_cap}_{ti}_{trs}")
            key_pipe = _cached_pipeline(
                keyframe_rf, (img, img, key), cache_dir, "vidkf_rf", _km)
            ref_pipe = _cached_pipeline(
                refine_rf,
                (img, img, dsp, dsp, forest_spec, forest_spec, key),
                cache_dir, "vidrf_rf", _km)
        return VideoStreamServer(
            key_pipe, ref_pipe, capacity=capacity,
            reseed_every=reseed_every, retries=retries,
            retry_backoff_s=retry_backoff_s, reuse_forest=True,
            scene_cut_ratio=scene_cut_ratio, lr_stat=_make_lr_stat(d),
        )
    if staged:
        vol_pipe = _staged_vol_pipe(h, w, d, cfg.volume_dtype,
                                    guided=volume_guided,
                                    cache_dir=cache_dir)
        seed_pipe = _staged_seed_pipe(h, w, sgbm_cfg, right_seed,
                                      cache_dir=cache_dir)
        kf_l, kf_r = (
            _staged_refine_pipe(
                cfg, h, w, d, tmax, adj_cap, fine_iterations,
                refine_start, max_neighbors, i, cache_dir=cache_dir,
            )
            for i in (0, 1)
        )
        rf_l, rf_r = (
            _staged_refine_pipe(
                cfg, h, w, d, tmax, adj_cap, ti, trs, max_neighbors, i,
                clip_span=span, cache_dir=cache_dir,
            )
            for i in (0, 1)
        )

        def kf_driver(lb, rb, k):
            vl, vr = vol_pipe(lb, rb)
            dl, dr = seed_pipe(lb, rb)
            return kf_l(lb, vl, dl, k), kf_r(rb, vr, dr, k)

        def rf_driver(lb, rb, pdl, pdr, k):
            vl, vr = vol_pipe(lb, rb)
            return rf_l(lb, vl, pdl, k), rf_r(rb, vr, pdr, k)

        key_pipe = StagedPipeline(
            (vol_pipe, seed_pipe, kf_l, kf_r), kf_driver, (img, img, key)
        )
        ref_pipe = StagedPipeline(
            (vol_pipe, rf_l, rf_r), rf_driver, (img, img, dsp, dsp, key)
        )
    else:
        def keyframe(left_bgr, right_bgr, key):
            vl, vr = builtin_cost_volumes(
                left_bgr[..., ::-1], right_bgr[..., ::-1], d,
                guided=volume_guided,
            )
            return _sgbm_mst_frame_fused(
                left_bgr, right_bgr, vl, vr, key, cfg, sgbm_cfg,
                fine_iterations, refine_start, max_neighbors, h, w,
                tmax, adj_cap, right_seed,
            )

        def refine(left_bgr, right_bgr, prev_dl, prev_dr, key):
            vl, vr = builtin_cost_volumes(
                left_bgr[..., ::-1], right_bgr[..., ::-1], d,
                guided=volume_guided,
            )
            return _mst_refine_frame_fused(
                left_bgr, right_bgr, vl, vr,
                jnp.clip(prev_dl, 0.0, span), jnp.clip(prev_dr, 0.0, span),
                key, cfg, ti, trs, max_neighbors, h, w, tmax, adj_cap,
            )

        _km = (f"{repr(cfg)}_{repr(sgbm_cfg)}_{fine_iterations}_"
               f"{refine_start}_{max_neighbors}_{right_seed}_"
               f"{tmax}_{adj_cap}_{ti}_{trs}")
        key_pipe = _cached_pipeline(
            keyframe, (img, img, key), cache_dir, "vidkf", _km)
        ref_pipe = _cached_pipeline(
            refine, (img, img, dsp, dsp, key), cache_dir, "vidrf", _km)
    return VideoStreamServer(
        key_pipe, ref_pipe, capacity=capacity, reseed_every=reseed_every,
        retries=retries, retry_backoff_s=retry_backoff_s,
        scene_cut_ratio=scene_cut_ratio, lr_stat=_make_lr_stat(d),
    )
