"""End-to-end cost-volume pipeline (SURVEY.md §3.4) functional tests."""

import numpy as np
import jax.numpy as jnp
import pytest

from stereomatch_tpu.config import (
    CostVolumeConfig,
    CostVolumePipelineConfig,
    DenoiseConfig,
    GuidedFilterConfig,
)
from stereomatch_tpu.models import cost_volume_stereo


def _synthetic_pair(rng, h=64, w=96, d=6):
    """Textured scene where right(x) = left(x + d) exactly (constant shift)."""
    base = (rng.random((h, w + d, 3)) * 255).astype(np.float32)
    # smooth horizontally a bit so gradients are informative but not aliased
    base = (base + np.roll(base, 1, axis=1) + np.roll(base, 2, axis=1)) / 3.0
    left = base[:, :w]
    right = base[:, d:]
    return left, right


def test_pipeline_recovers_constant_shift(rng):
    true_d = 6
    left, right = _synthetic_pair(rng, d=true_d)
    cfg = CostVolumePipelineConfig(
        volume=CostVolumeConfig(min_disp=0, max_disp=15),
        guided=GuidedFilterConfig(radius=4, slab=8),
        denoise=DenoiseConfig(iterations=20),
    )
    out = cost_volume_stereo(jnp.asarray(left), jnp.asarray(right), cfg)
    raw = np.asarray(out.left_raw)
    inner = raw[10:-10, 10 + true_d : -10]
    assert np.abs(inner - true_d).mean() < 0.5, np.abs(inner - true_d).mean()
    # denoised result should stay near the true plane too
    den = np.asarray(out.left_disp)[10:-10, 10 + true_d : -10]
    assert np.abs(den - true_d).mean() < 1.0
    # right view symmetric
    raw_r = np.asarray(out.right_raw)[10:-10, 10 : -10 - true_d]
    assert np.abs(raw_r - true_d).mean() < 0.5


@pytest.mark.requires_reference
def test_pipeline_flir_smoke(flir_pair):
    """Run the production-shaped pipeline on a real (downsampled) FLIR pair
    and check output sanity: finite, in range, nontrivial variation."""
    left, right = flir_pair  # (H, W, 3) uint8-ish arrays, RGB
    h, w = left.shape[:2]
    cfg = CostVolumePipelineConfig(
        volume=CostVolumeConfig(min_disp=0, max_disp=31),
        guided=GuidedFilterConfig(radius=4, slab=8),
        denoise=DenoiseConfig(iterations=10),
    )
    bgr_l = jnp.asarray(left[..., ::-1].astype(np.float32))
    bgr_r = jnp.asarray(right[..., ::-1].astype(np.float32))
    out = cost_volume_stereo(bgr_l, bgr_r, cfg, lr_check=True)
    disp = np.asarray(out.left_disp)
    assert disp.shape == (h, w)
    assert np.isfinite(disp).all()
    assert disp.min() >= 0.0 and disp.max() <= 31.0
    assert disp.std() > 0.1
