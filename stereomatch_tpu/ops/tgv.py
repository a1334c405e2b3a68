"""Second-order TGV refinement with anisotropic diffusion tensor.

Data-parallel implementation of the reference's AL-TGV kernel family
(src/PatchMatchStereoGPU.cu): anisotropicDiffusionTensorG (:4412-4487),
AL_TGV_dualUpdate (:4491-4552), AL_TGV_computeGp (:4554-4566),
AL_TGV_primalUpdate (:4568-4641), AL_TGV_augmentedLagranianUpdate
(:4643-4655), Init2TGV (:4657-4663), with the production step sizes
tau_p = tau_q = 1/2, tau_u = 1/4, tau_v = 1/8 (.cu:6807-6810).

In the reference the TGV main loop is dead code (unreachable after the
goto at .cu:7328); this module provides the LIVE equivalent: a standalone
TGV-2 denoiser `tgv2_refine` that smooths a [0,1] disparity field with an
augmented-Lagrangian coupling to the input (the role the loop at
.cu:7331-7727 was meant to play after PatchMatch/MST). The reference's LSD
line-segment mask (cv::createLineSegmentDetector, .cu:6368-6400) is
replaced by a gradient-magnitude line response (`line_response`), per
SURVEY.md §7.8.

Every step is a pure 4-neighbor stencil — one fused XLA pass per update.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

__all__ = [
    "diffusion_tensor",
    "line_response",
    "lsd_line_mask",
    "tgv2_refine",
    "TGVParams",
]


class TGVParams(NamedTuple):
    lambda_s: float = 0.2  # first-order dual bound (edge term)
    lambda_a: float = 0.8  # second-order dual bound
    tau_p: float = 0.5
    tau_q: float = 0.5
    tau_u: float = 0.25
    tau_v: float = 0.125
    theta_inv: float = 2.0  # data-coupling strength 1/theta
    tensor_a: float = 5.0  # diffusion tensor exp(-a*|grad|^b)
    tensor_b: float = 0.5
    iterations: int = 100
    # The reference's AL multiplier update (.cu:4643-4655) couples u to a
    # PatchMatch data term that is re-optimized between TGV rounds; in
    # standalone refinement it would drive u back to the noisy input, so it
    # is off unless the caller runs the full alternating scheme.
    lagrangian: bool = False


def _central_grad(img: jax.Array):
    """Central differences with one-sided borders (.cu:4428-4436)."""
    h, w = img.shape
    dx = jnp.concatenate(
        [
            (img[:, 1:2] - img[:, 0:1]),
            (img[:, 2:] - img[:, :-2]) * 0.5,
            (img[:, -1:] - img[:, -2:-1]),
        ],
        axis=1,
    )
    dy = jnp.concatenate(
        [
            (img[1:2] - img[0:1]),
            (img[2:] - img[:-2]) * 0.5,
            (img[-1:] - img[-2:-1]),
        ],
        axis=0,
    )
    return dx, dy


def line_response(gray: jax.Array, threshold: float = 20.0) -> jax.Array:
    """Cheap line-segment stand-in for the reference's LSD mask: gradient
    magnitude thresholded to a soft [0,1] mask."""
    dx, dy = _central_grad(gray)
    mag = jnp.sqrt(dx * dx + dy * dy)
    return jnp.clip(mag / threshold, 0.0, 1.0)


def lsd_line_mask(gray, sigma: float = 1.0):
    """The reference's exact LSD line-segment mask (host-side, needs cv2):
    cv::createLineSegmentDetector(LSD_REFINE_ADV) segments drawn 1 px wide
    into a binary mask, scaled to [0,1] and Gaussian-blurred with
    sigma=1.0 (src/PatchMatchStereoGPU.cu:6368-6396; the reference leaves
    its mask buffer uninitialized before drawing — here it is zeroed).
    `line_response` is the in-graph stand-in; their agreement on the FLIR
    frame is quantified in tests/test_tgv.py::test_lsd_line_mask_agreement.
    Returns an (H, W) float32 numpy mask."""
    import cv2
    import numpy as np_

    g8 = np_.clip(np_.asarray(gray), 0, 255).astype(np_.uint8)
    lsd = cv2.createLineSegmentDetector(cv2.LSD_REFINE_ADV)
    lines = lsd.detect(g8)[0]
    mask = np_.zeros(g8.shape, np_.uint8)
    if lines is not None:
        for l in np_.asarray(lines).reshape(-1, 4):
            cv2.line(
                mask,
                (int(round(float(l[0]))), int(round(float(l[1])))),
                (int(round(float(l[2]))), int(round(float(l[3])))),
                255,
                1,
            )
    m = mask.astype(np_.float32) / 255.0
    return cv2.GaussianBlur(m, (0, 0), float(sigma))


def diffusion_tensor(
    gray_gauss: jax.Array,
    ls_mask: jax.Array | None = None,
    a: float = 5.0,
    b: float = 0.5,
) -> jax.Array:
    """Anisotropic diffusion tensor G (H, W, 4) = [[g00 g01], [g10 g11]]
    (ref: anisotropicDiffusionTensorG, .cu:4412-4487): with n = normalized
    image gradient and s = exp(-a |grad|^b),
        G = s n n^T + (I - n n^T)
    i.e. diffusion suppressed across edges, free along them. Where the line
    mask is active, the tensor is recomputed from the mask's gradient."""
    zero = 1e-4

    def tensor_from(img):
        dx, dy = _central_grad(img)
        mag2 = dx * dx + dy * dy
        s = jnp.exp(-a * jnp.power(jnp.maximum(mag2, 0.0), b * 0.5))
        norm = jnp.sqrt(mag2)
        ok = norm > zero
        nx = jnp.where(ok, dx / jnp.maximum(norm, zero), 0.0)
        ny = jnp.where(ok, dy / jnp.maximum(norm, zero), 0.0)
        g00 = jnp.where(ok, s * nx * nx + ny * ny, 1.0)
        g01 = jnp.where(ok, (s - 1.0) * nx * ny, 0.0)
        g11 = jnp.where(ok, s * ny * ny + nx * nx, 1.0)
        return jnp.stack([g00, g01, g01, g11], axis=-1)

    g = tensor_from(gray_gauss)
    if ls_mask is not None:
        g_line = tensor_from(ls_mask)
        g = jnp.where((ls_mask >= zero)[..., None], g_line, g)
    return g


def _fwd_diff(f: jax.Array):
    """Forward differences, zero at last col/row (.cu:4504-4505)."""
    dx = jnp.pad(f[:, 1:] - f[:, :-1], ((0, 0), (0, 1)))
    dy = jnp.pad(f[1:] - f[:-1], ((0, 1), (0, 0)))
    return dx, dy


def _div(px: jax.Array, py: jax.Array):
    """Backward-difference divergence, reference boundary rule
    (.cu:4580-4588): first col/row keep p, last take -p[prev]."""
    h, w = px.shape
    div_x = jnp.concatenate(
        [px[:, :1], px[:, 1 : w - 1] - px[:, : w - 2], -px[:, w - 2 : w - 1]], axis=1
    )
    div_y = jnp.concatenate(
        [py[:1], py[1 : h - 1] - py[: h - 2], -py[h - 2 : h - 1]], axis=0
    )
    return div_x + div_y


def tgv2_refine(
    u0: jax.Array,
    guide_gray: jax.Array,
    params: TGVParams = TGVParams(),
    ls_mask: jax.Array | None = None,
    tgv: bool = True,
) -> jax.Array:
    """TGV-2 (or TV if tgv=False) refinement of a [0,1] field u0 with
    anisotropic tensor G from the guide image and augmented-Lagrangian
    coupling to u0 (the 'd_a' field of AL_TGV_primalUpdate).

    Per iteration (kernel order follows the intended host loop):
      p += tau_p * G (grad u - v); project |p| <= lambda_s
      q += tau_q * grad v;         project |q| <= lambda_a
      u  = clip01((u + tau_u (div Gp - L + theta_inv a)) / (1 + tau_u theta_inv));
           over-relaxed (.cu:4597-4601)
      v += tau_v (p + div q); over-relaxed
      L += (u - a) * theta_inv / 2   (.cu:4643-4655)
    """
    g = diffusion_tensor(guide_gray, ls_mask, params.tensor_a, params.tensor_b)
    g00, g01, g10, g11 = g[..., 0], g[..., 1], g[..., 2], g[..., 3]
    a_field = u0

    def body(_, state):
        u, vx, vy, px, py, qxx, qxy, qyx, qyy, lagr = state
        du_dx, du_dy = _fwd_diff(u)
        ex, ey = du_dx - vx, du_dy - vy
        px_n = px + params.tau_p * (g00 * ex + g01 * ey)
        py_n = py + params.tau_p * (g10 * ex + g11 * ey)
        norm = jnp.sqrt(px_n * px_n + py_n * py_n)
        scale = jnp.maximum(1.0, norm / params.lambda_s)
        px_n, py_n = px_n / scale, py_n / scale

        if tgv:
            dvx_dx, dvx_dy = _fwd_diff(vx)
            dvy_dx, dvy_dy = _fwd_diff(vy)
            qxx_n = qxx + params.tau_q * dvx_dx
            qxy_n = qxy + params.tau_q * dvx_dy
            qyx_n = qyx + params.tau_q * dvy_dx
            qyy_n = qyy + params.tau_q * dvy_dy
            qn = jnp.sqrt(qxx_n**2 + qxy_n**2 + qyx_n**2 + qyy_n**2)
            qs = jnp.maximum(1.0, qn / params.lambda_a)
            qxx_n, qxy_n, qyx_n, qyy_n = qxx_n / qs, qxy_n / qs, qyx_n / qs, qyy_n / qs
        else:
            qxx_n, qxy_n, qyx_n, qyy_n = qxx, qxy, qyx, qyy

        gpx = g00 * px_n + g01 * py_n
        gpy = g10 * px_n + g11 * py_n
        u_t = (
            u
            + params.tau_u * _div(gpx, gpy)
            - params.tau_u * lagr
            + params.tau_u * params.theta_inv * a_field
        ) / (1.0 + params.tau_u * params.theta_inv)
        u_t = jnp.clip(u_t, 0.0, 1.0)
        u_n = 2.0 * u_t - u

        if tgv:
            vx_t = vx + params.tau_v * (px_n + _div(qxx_n, qxy_n))
            vy_t = vy + params.tau_v * (py_n + _div(qyx_n, qyy_n))
            vx_n, vy_n = 2.0 * vx_t - vx, 2.0 * vy_t - vy
        else:
            vx_n, vy_n = vx, vy

        if params.lagrangian:
            lagr_n = lagr + (u_n - a_field) * 0.5 * params.theta_inv
        else:
            lagr_n = lagr
        return (u_n, vx_n, vy_n, px_n, py_n, qxx_n, qxy_n, qyx_n, qyy_n, lagr_n)

    z = jnp.zeros_like(u0)
    state = (u0, z, z, z, z, z, z, z, z, z)
    state = jax.lax.fori_loop(0, params.iterations, body, state)
    return state[0]
