"""TGV-2 refinement (ref kernels: src/PatchMatchStereoGPU.cu:4412-4663)."""

import numpy as np
import pytest
import jax.numpy as jnp

from stereomatch_tpu.ops.tgv import TGVParams, diffusion_tensor, tgv2_refine


def test_diffusion_tensor_structure(rng):
    gray = (rng.random((12, 16)) * 255).astype(np.float32)
    g = np.asarray(diffusion_tensor(jnp.asarray(gray), a=5.0, b=0.5))
    # symmetric 2x2, eigenvalues in (0, 1]: along-edge direction keeps 1
    np.testing.assert_allclose(g[..., 1], g[..., 2])
    tr = g[..., 0] + g[..., 3]
    det = g[..., 0] * g[..., 3] - g[..., 1] * g[..., 2]
    disc = np.sqrt(np.maximum(tr * tr / 4 - det, 0))
    lo, hi = tr / 2 - disc, tr / 2 + disc
    assert (hi <= 1.0 + 1e-5).all()
    # s = exp(-a |grad|^b) underflows to 0 at very strong edges; fp32
    # roundoff can push the small eigenvalue epsilon-negative
    assert (lo >= -1e-6).all()
    # flat image -> identity tensor
    flat = np.full((8, 8), 7.0, np.float32)
    gf = np.asarray(diffusion_tensor(jnp.asarray(flat)))
    np.testing.assert_allclose(gf[..., 0], 1.0)
    np.testing.assert_allclose(gf[..., 3], 1.0)
    np.testing.assert_allclose(gf[..., 1], 0.0)


def test_nl2tgv_denoises(rng):
    """NL2TGV (ref .cu:4805-5103) must reduce noise on a piecewise-planar
    field with color-aligned support weights."""
    from stereomatch_tpu.ops.nltgv import NL2TGVParams, nl2tgv_refine, support_weights

    h, w = 32, 40
    xs = np.arange(w, dtype=np.float32)[None, :]
    clean = np.clip(xs / w, 0, 1) * np.ones((h, 1), np.float32)
    clean[:, : w // 3] = 0.3
    noisy = np.clip(clean + rng.normal(0, 0.08, (h, w)).astype(np.float32), 0, 1)
    bgr = np.repeat((clean * 255)[..., None], 3, axis=-1).astype(np.float32)
    params = NL2TGVParams(iterations=120)
    # support weights: in [0,1], zero out of bounds, high on flat color
    a1 = np.asarray(support_weights(jnp.asarray(bgr / 255.0), params))
    assert a1.shape == (h, w, 12)
    assert a1.max() <= 1.0 + 1e-6 and a1.min() >= 0.0
    assert a1[..., 0].max() > 0.5  # nearest neighbor on flat color
    out = np.asarray(nl2tgv_refine(jnp.asarray(noisy), jnp.asarray(bgr), params))
    assert np.isfinite(out).all()
    assert np.abs(out - clean).mean() < 0.6 * np.abs(noisy - clean).mean()


def test_tgv2_denoises_piecewise_planar(rng):
    """TGV-2 should recover a piecewise-LINEAR field from noise (that is
    its advantage over TV, which staircases ramps)."""
    h, w = 48, 64
    xs = np.arange(w, dtype=np.float32)[None, :]
    clean = np.clip(xs / w, 0, 1) * np.ones((h, 1), np.float32)  # ramp
    clean[:, : w // 3] = 0.2  # one flat region with a jump
    noisy = np.clip(clean + rng.normal(0, 0.08, (h, w)).astype(np.float32), 0, 1)
    guide = (clean * 255).astype(np.float32)  # edges aligned with the jump
    params = TGVParams(iterations=200)
    out = np.asarray(tgv2_refine(jnp.asarray(noisy), jnp.asarray(guide), params))
    assert np.abs(out - clean).mean() < 0.5 * np.abs(noisy - clean).mean()
    assert np.isfinite(out).all() and out.min() >= 0.0 and out.max() <= 1.0


@pytest.mark.requires_reference
def test_lsd_line_mask_agreement():
    """Quantified fidelity of the gradient line_response stand-in vs the
    reference's real LSD mask (cv2 LSD_REFINE_ADV + 1px draw + sigma-1
    Gaussian, .cu:6368-6396) on the real FLIR frame: >= 85% of LSD line
    pixels must fall inside the dilated line_response support, and both
    masks select sparse structure."""
    cv2 = pytest.importorskip("cv2")
    from stereomatch_tpu.io import load_image
    from stereomatch_tpu.ops.tgv import line_response, lsd_line_mask

    L = load_image("/root/reference/build/000020_191400042.jpg")[::4, ::4]
    L = L.astype(np.float32)
    gray = 0.299 * L[..., 0] + 0.587 * L[..., 1] + 0.114 * L[..., 2]
    m = lsd_line_mask(gray)
    assert m.shape == gray.shape and m.dtype == np.float32
    assert 0.0 <= m.min() and m.max() <= 1.0
    lsd_frac = (m > 0.2).mean()
    assert 0.005 < lsd_frac < 0.3, lsd_frac  # sparse line structure

    lr = np.asarray(line_response(jnp.asarray(gray)))  # default threshold
    resp_frac = (lr > 0.5).mean()
    assert 0.01 < resp_frac < 0.4, resp_frac
    supd = cv2.dilate((lr > 0.5).astype(np.uint8), np.ones((5, 5), np.uint8))
    recall = (supd[m > 0.2] > 0).mean()  # measured 0.94 at quarter scale
    assert recall >= 0.85, recall
