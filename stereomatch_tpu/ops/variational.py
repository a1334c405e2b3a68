"""Variational refinement: weighted-Huber primal-dual disparity denoise.

Data-parallel replacement for the reference's "Family E" denoise path
(ref: variationalDisparityDenoise host loop, src/PatchMatchStereoGPU.cu:
7809-7940; weightedHuberDenoiseDualUpdate / PrimalUpdate kernels
:1042-1126; weight + normalize kernel perPixelWeightPlusNormalizeImg
:1001-1040). Each primal-dual iteration is a pure 4-neighbor stencil —
one fused XLA elementwise pass per update — driven by `lax.fori_loop`.

Model (Newcombe-style weighted Huber-ROF on the [0,1]-normalized disparity):
    min_u  sum w|∇u|_delta + lambda |u - f|_gamma
with per-pixel edge weight w = exp(-alpha |∇I/255|^beta).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import DenoiseConfig

__all__ = ["edge_weight", "huber_denoise", "variational_disparity_denoise"]


def _grad_fwd(u: jax.Array):
    """Forward differences, zero at the last column/row
    (ref: .cu:1012-1013, :1054-1055)."""
    dx = jnp.pad(u[:, 1:] - u[:, :-1], ((0, 0), (0, 1)))
    dy = jnp.pad(u[1:, :] - u[:-1, :], ((0, 1), (0, 0)))
    return dx, dy


def _div_bwd(px: jax.Array, py: jax.Array):
    """Backward-difference divergence with the reference's boundary rule
    (.cu:1110-1117): first col/row keep p, last col/row take -p[prev]."""
    h, w = px.shape
    div_x = jnp.concatenate(
        [px[:, :1], px[:, 1 : w - 1] - px[:, : w - 2], -px[:, w - 2 : w - 1]], axis=1
    )
    div_y = jnp.concatenate(
        [py[:1, :], py[1 : h - 1, :] - py[: h - 2, :], -py[h - 2 : h - 1, :]], axis=0
    )
    return div_x + div_y


def edge_weight(gray: jax.Array, alpha: float = 10.0, beta: float = 1.0) -> jax.Array:
    """Per-pixel weight exp(-alpha*|∇(I/255)|^beta)
    (ref: perPixelWeightPlusNormalizeImg, .cu:1001-1023). gray in [0, 255]."""
    dx, dy = _grad_fwd(gray * (1.0 / 255.0))
    mag = jnp.sqrt(dx * dx + dy * dy)
    return jnp.exp(-alpha * jnp.abs(mag) ** beta)


def huber_denoise(
    f: jax.Array, weight: jax.Array, cfg: DenoiseConfig = DenoiseConfig()
) -> jax.Array:
    """Primal-dual weighted-Huber denoise of a [0,1] field `f`.

    Per iteration (ref kernel order: dual then primal, .cu:7873-7879):
      q  <- prox( (q + sigma (u - f)) / (1 + sigma gamma), |.| <= lambda )
      p  <- prox( (p + sigma ∇u) / (1 + sigma delta), |.| <= w isotropic )
      u  <- u + 2 tau (div p - lambda q)      [over-relaxed in place,
                                               .cu:1123]
    """
    def body(_, state):
        u, q, px, py = state
        dx, dy = _grad_fwd(u)
        q_new = (q + cfg.sigma * (u - f)) / (1.0 + cfg.sigma * cfg.gamma)
        q_new = q_new / jnp.maximum(1.0, jnp.abs(q_new) / cfg.lam)
        px_new = (px + cfg.sigma * dx) / (1.0 + cfg.sigma * cfg.delta)
        py_new = (py + cfg.sigma * dy) / (1.0 + cfg.sigma * cfg.delta)
        norm = jnp.maximum(
            1.0, jnp.sqrt(px_new * px_new + py_new * py_new) / weight
        )
        px_new, py_new = px_new / norm, py_new / norm
        u_new = u + 2.0 * cfg.tau * (_div_bwd(px_new, py_new) - cfg.lam * q_new)
        return u_new, q_new, px_new, py_new

    zeros = jnp.zeros_like(f)
    u, _, _, _ = jax.lax.fori_loop(0, cfg.iterations, body, (f, zeros, zeros, zeros))
    return u


def variational_disparity_denoise(
    disp: jax.Array,
    gray: jax.Array,
    min_disp: int,
    max_disp: int,
    cfg: DenoiseConfig = DenoiseConfig(),
) -> jax.Array:
    """End-to-end denoise matching the reference host function
    (.cu:7809-7940): normalize disparity to [0,1] over [min_disp, max_disp]
    (.cu:1019), run `iterations` primal-dual steps, scale back (.cu:1033-1037).
    `gray` is the guide image in [0, 255]."""
    span = float(max_disp - min_disp)
    f = (disp - float(min_disp)) / span
    w = edge_weight(gray, cfg.alpha, cfg.beta)
    u = huber_denoise(f, w, cfg)
    return u * span + float(min_disp)
