"""Non-local second-order TGV (NL2TGV) refinement.

Data-parallel implementation of the reference's NL2TGV kernel family
(src/PatchMatchStereoGPU.cu): InitNL2TGV (:4805-4826), InitAlpha1
(:4829-4871), NL2TGV_primalUpdate (:4874-4955), NL2TGV_dualUpdate
(:4958-5103), with the diagonal preconditioning of the kernels
(sigma_p = sigma_q = 1/2, tau_u = 1/(2 n), tau_w = 1/(4 n)).

Support structure: the CAUSAL HALF of a (2r+1)^2 neighborhood —
n = 2r(r+1) offsets with h in [0, r], w in [-r, r], skipping h=0, w<=0 —
each pixel i holds duals p(i, j) (scalar) and q(i, j) (2-vector) toward
each half-neighbor j; the mirrored contributions realize the full
neighborhood divergence. Support weights alpha1(i, j) =
exp(-||c_i - c_j||_2 * w_ci - dist(i, j) * w_pi) (ref :4865).

The reference's loop is dead code (unreachable, .cu:7328); this is the
live equivalent, a standalone refiner for a [0,1] disparity field.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

__all__ = ["NL2TGVParams", "nl2tgv_refine", "support_weights"]


class NL2TGVParams(NamedTuple):
    support_radius: int = 2
    lambda_s: float = 0.2
    lambda_a: float = 8.0
    w_ci: float = 25.5  # color similarity (images scaled to [0,1])
    w_pi: float = 0.5  # proximity = 1/support_radius by default
    theta_inv: float = 2.0
    iterations: int = 100
    tgv: bool = True
    lagrangian: bool = False


def _offsets(r: int):
    offs = []
    count = -1
    for h in range(0, r + 1):
        for w in range(-r, r + 1):
            count += 1
            if count <= r:
                continue
            offs.append((h, w))
    return offs


def _shift(x: jax.Array, dy: int, dx: int, fill: float = 0.0) -> jax.Array:
    """out[y, x] = x[y + dy, x + dx], out-of-bounds -> fill."""
    h, w = x.shape[:2]
    pad = [(max(0, -dy), max(0, dy)), (max(0, -dx), max(0, dx))] + [(0, 0)] * (
        x.ndim - 2
    )
    xp = jnp.pad(x, pad, constant_values=fill)
    y0 = dy + max(0, -dy)
    x0 = dx + max(0, -dx)
    out = xp[y0 : y0 + h, x0 : x0 + w]
    return out


def support_weights(bgr01: jax.Array, params: NL2TGVParams) -> jax.Array:
    """alpha1 (H, W, n): exp(-||dc||_2 w_ci - dist w_pi); 0 when the
    neighbor is outside the image (ref InitAlpha1, .cu:4829-4871)."""
    h, w = bgr01.shape[:2]
    offs = _offsets(params.support_radius)
    ys = jnp.arange(h)[:, None]
    xs = jnp.arange(w)[None, :]
    planes = []
    for dy, dx in offs:
        nb = _shift(bgr01, dy, dx)
        cdiff = jnp.sqrt(jnp.sum((bgr01 - nb) ** 2, axis=-1))
        dist = (dy * dy + dx * dx) ** 0.5
        a = jnp.exp(-cdiff * params.w_ci - dist * params.w_pi)
        inb = (ys + dy < h) & (xs + dx >= 0) & (xs + dx < w)
        planes.append(jnp.where(inb, a, 0.0))
    return jnp.stack(planes, axis=-1)


def nl2tgv_refine(
    u0: jax.Array,
    bgr: jax.Array,
    params: NL2TGVParams = NL2TGVParams(),
) -> jax.Array:
    """NL2TGV refinement of a [0,1] field u0 guided by a BGR image in
    [0,255]. Returns the refined field."""
    h, w = u0.shape
    offs = _offsets(params.support_radius)
    n = len(offs)
    alpha1 = support_weights(bgr.astype(jnp.float32) / 255.0, params)
    a_field = u0
    sigma_p = 0.5
    sigma_q = 0.5
    tau_u = 1.0 / (2.0 * n)
    tau_w = 1.0 / (4.0 * n)

    ys = jnp.arange(h)[:, None]
    xs = jnp.arange(w)[None, :]
    inb = jnp.stack(
        [
            (ys + dy < h) & (xs + dx >= 0) & (xs + dx < w)
            for dy, dx in offs
        ],
        axis=-1,
    )

    def body(_, state):
        u, wx, wy, p, q, lagr = state
        # ---- dual update (per half-neighbor j) ----
        new_p = []
        new_q = []
        for k, (dy, dx) in enumerate(offs):
            u_j = _shift(u, dy, dx)
            pk = p[..., k] + sigma_p * (u_j - u - dx * wx - dy * wy)
            new_p.append(jnp.where(inb[..., k], pk, 0.0))
            if params.tgv:
                qx = q[..., k, 0] + sigma_q * (_shift(wx, dy, dx) - wx)
                qy = q[..., k, 1] + sigma_q * (_shift(wy, dy, dx) - wy)
                new_q.append(
                    jnp.stack(
                        [
                            jnp.where(inb[..., k], qx, 0.0),
                            jnp.where(inb[..., k], qy, 0.0),
                        ],
                        axis=-1,
                    )
                )
        p_new = jnp.stack(new_p, axis=-1)
        norm_p = jnp.sqrt(jnp.sum(p_new * p_new, axis=-1, keepdims=True))
        bound_p = alpha1 * params.lambda_s
        p_new = p_new / jnp.maximum(1.0, norm_p / jnp.maximum(bound_p, 1e-20))
        p_new = jnp.where(bound_p > 0, p_new, 0.0)
        if params.tgv:
            q_new = jnp.stack(new_q, axis=-2)  # (H, W, n, 2)
            norm_q = jnp.sqrt(jnp.sum(q_new * q_new, axis=(-2, -1), keepdims=True))
            bound_q = (params.lambda_a * bound_p)[..., None]
            q_new = q_new / jnp.maximum(1.0, norm_q / jnp.maximum(bound_q, 1e-20))
            q_new = jnp.where(bound_q > 0, q_new, 0.0)
        else:
            q_new = q

        # ---- primal update: nonlocal divergence ----
        div_p = jnp.zeros_like(u)
        div_qx = jnp.zeros_like(u)
        div_qy = jnp.zeros_like(u)
        for k, (dy, dx) in enumerate(offs):
            div_p = div_p + p_new[..., k] - _shift(p_new[..., k], -dy, -dx)
            if params.tgv:
                div_qx = (
                    div_qx
                    + q_new[..., k, 0]
                    + dx * p_new[..., k]
                    - _shift(q_new[..., k, 0], -dy, -dx)
                )
                div_qy = (
                    div_qy
                    + q_new[..., k, 1]
                    + dy * p_new[..., k]
                    - _shift(q_new[..., k, 1], -dy, -dx)
                )

        u_t = (
            u + tau_u * div_p - tau_u * lagr + tau_u * params.theta_inv * a_field
        ) / (1.0 + tau_u * params.theta_inv)
        u_t = jnp.clip(u_t, 0.0, 1.0)
        u_new = 2.0 * u_t - u

        if params.tgv:
            wx_t = wx + tau_w * div_qx
            wy_t = wy + tau_w * div_qy
            wx_new, wy_new = 2.0 * wx_t - wx, 2.0 * wy_t - wy
        else:
            wx_new, wy_new = wx, wy

        lagr_new = (
            lagr + (u_new - a_field) * 0.5 * params.theta_inv
            if params.lagrangian
            else lagr
        )
        return (u_new, wx_new, wy_new, p_new, q_new, lagr_new)

    z = jnp.zeros_like(u0)
    state = (
        u0,
        z,
        z,
        jnp.zeros((h, w, n)),
        jnp.zeros((h, w, n, 2)),
        z,
    )
    state = jax.lax.fori_loop(0, params.iterations, body, state)
    return state[0]

