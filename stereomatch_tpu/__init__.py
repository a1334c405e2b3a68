"""stereomatch_tpu — a dense two-view stereo engine in JAX.

Built from scratch in JAX/XLA with the capability surface of the
reference C++/CUDA codebase lr-xiang/StereoMatch: calibration-driven
rectification, census/BT/ZNCC/AD-gradient matching-cost volumes (plus mc-cnn
cost-volume ingestion), three aggregation backends (SGBM 8-path DP as
vectorized scans, Stereo3DMST segment-tree filtering, slanted-plane
PatchMatch), WTA + subpixel disparity selection, LR consistency / occlusion
fill / weighted median post-processing, variational refinement, and 3D
reprojection — sharded over device meshes by image tiles and disparity slabs.
"""

__version__ = "0.1.0"

from . import config  # noqa: F401

_LAZY = (
    "pipelines",
    "eval",
    "io",
    "geometry",
    "ops",
    "models",
    "parallel",
    "serving",
    "utils",
)


def __getattr__(name):
    if name in _LAZY:
        import importlib

        mod = importlib.import_module(f".{name}", __name__)
        globals()[name] = mod
        return mod
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
