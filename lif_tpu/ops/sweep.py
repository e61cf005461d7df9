"""Plane-sweep rendering: the matmul-shaped alternative to the per-pixel march.

The ray march (ops/raycast.py) is exact but gather-bound and has zero
gradient w.r.t. the depth map (surface crossings are discrete decisions).
The plane sweep evaluates a FIXED set of inverse-depth planes
invZ_k (k = 1..K, from invz_min toward invz_max, the same range the march
scans): at plane k every output pixel samples the source at

    s1_k = C.xy * invZ_k + (1 - C.z * invZ_k) * q(s2),

a data-INDEPENDENT position field. Occupancy per plane is a soft surface
test, composited front-to-back like a multiplane image:

    o_k = sigmoid((d_k - invZ_k) * sharpness / range) * border * mask
    w_k = o_k * prod_{j<k} (1 - o_j)

This is fully differentiable w.r.t. the depth map AND pose (the training
path), and in the hard limit (sharpness -> inf) converges to the march's
front surface. reference semantics approximated: rayCastMonoLDI.glsl:219-297.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..core.color import linear_to_srgb
from ..core.transforms import inv3, mat_from_focal, mm
from .raycast import _pixel_grid, build_fskr2, build_skr1, taper
from .sampling import bilinear_sample, read_disp

__all__ = ["render_sweep"]

DEFAULT_PLANES = 40  # match the march's step count


@functools.partial(
    jax.jit,
    static_argnames=("out_w", "out_h", "num_layers", "num_planes", "to_srgb",
                     "full_w", "full_h"),
)
def render_sweep(
    rgb,
    disp,
    mask,
    layer_res,
    invz_min,
    invz_max,
    focal,
    skew1,
    c1,
    rot1,
    f2,
    skew2,
    background,
    out_w: int,
    out_h: int,
    num_layers: int,
    num_planes: int = DEFAULT_PLANES,
    sharpness: float = 120.0,
    feathering: float = 0.1,
    to_srgb: bool = True,
    full_w: int | None = None,
    full_h: int | None = None,
    row_start=0,
    col_start=0,
):
    """Soft plane-sweep render (differentiable). Same argument layout as
    ops.raycast.render_mono; `sharpness` controls the softness of the
    surface test (in units of the inverse-depth range)."""
    s2x, s2y = _pixel_grid(
        out_w, out_h, full_w=full_w, full_h=full_h,
        row_start=row_start, col_start=col_start,
    )
    fb_w = float(out_w if full_w is None else full_w)
    fb_h = float(out_h if full_h is None else full_h)
    skr1 = build_skr1(skew1, rot1)
    fskr2 = build_fskr2(f2, fb_w, fb_h, skew2)
    background = jnp.asarray(background, jnp.float32)
    layer_res_f = layer_res.astype(jnp.float32)
    c1 = c1.astype(jnp.float32)

    def bc(x):
        return jnp.asarray(x, jnp.float32)[..., None, None]

    out_rgb = None
    out_a = None
    for i in range(num_layers):
        res_w = layer_res_f[i, 0]
        res_h = layer_res_f[i, 1]
        fskr1 = mm(mat_from_focal(focal[i] / res_w, focal[i] / res_h), skr1)
        p = mm(fskr1, inv3(fskr2))
        c = jnp.matmul(
            jnp.broadcast_to(fskr1, p.shape), (-c1)[..., None],
            precision=jax.lax.Precision.HIGHEST,
        )[..., 0]

        denom = bc(p[..., 2, 0]) * s2x + bc(p[..., 2, 1]) * s2y + bc(p[..., 2, 2])
        qx = (bc(p[..., 0, 0]) * s2x + bc(p[..., 0, 1]) * s2y + bc(p[..., 0, 2])) / denom
        qy = (bc(p[..., 1, 0]) * s2x + bc(p[..., 1, 1]) * s2y + bc(p[..., 1, 2])) / denom
        c_x, c_y, c_z = bc(c[..., 0]), bc(c[..., 1]), bc(c[..., 2])

        izmin = invz_min[i]
        izmax = invz_max[i]
        rng = izmin - izmax
        sharp = sharpness / jnp.maximum(rng, 1e-9)

        def plane_step(carry, frac):
            transmittance, acc_rgb, acc_a = carry
            invz_k = izmin + (izmax - izmin) * frac  # near -> far
            s1x = c_x * invz_k + (1.0 - c_z * invz_k) * qx
            s1y = c_y * invz_k + (1.0 - c_z * invz_k) * qy
            u1 = s1x + 0.5
            v1 = s1y + 0.5
            d_k = read_disp(disp[i], u1, v1, izmin, izmax, res_w, res_h)
            inside = (
                (jnp.abs(s1x) < 0.5) & (jnp.abs(s1y) < 0.5)
            ).astype(jnp.float32)
            m_k = bilinear_sample(mask[i], u1, v1, res_w, res_h)
            # occupancy CONSUMES the ray even out of bounds (the march's
            # crossing against the edge-clamped surface also stops the ray
            # and then reports a miss there); visibility only scales the
            # contribution.
            occ = jax.nn.sigmoid((d_k - invz_k) * sharp)
            tap = taper(u1, v1, feathering)
            vis = inside * m_k * tap
            col_k = bilinear_sample(rgb[i], u1, v1, res_w, res_h)
            w_k = transmittance * occ
            return (
                transmittance * (1.0 - occ),
                acc_rgb + (w_k * vis)[..., None] * col_k,
                acc_a + w_k * vis,
            ), None

        fracs = (jnp.arange(num_planes, dtype=jnp.float32) + 0.5) / num_planes
        shape = jnp.broadcast_shapes(denom.shape)
        init = (
            jnp.ones(shape, jnp.float32),
            jnp.zeros(shape + (3,), jnp.float32),
            jnp.zeros(shape, jnp.float32),
        )
        (transmittance, acc_rgb, acc_a), _ = jax.lax.scan(
            plane_step, init, fracs
        )

        layer_rgb = acc_rgb
        layer_a = acc_a
        if out_rgb is None:
            out_rgb = layer_rgb
            out_a = layer_a
        else:
            out_rgb = out_rgb + (1.0 - out_a[..., None]) * layer_rgb
            out_a = out_a + (1.0 - out_a) * layer_a

    out_rgb = background[:3] * background[3] * (1.0 - out_a[..., None]) + out_rgb
    out_a = background[3] + out_a * (1.0 - background[3])
    if to_srgb:
        out_rgb = linear_to_srgb(out_rgb)
    return jnp.concatenate([out_rgb, out_a[..., None]], axis=-1)
