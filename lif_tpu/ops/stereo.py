"""Two-view (stereo) LDI rendering: view weighting, occlusion fill, blend.

The JAX equivalent of the stereo raycast kernel
(reference: src/shaders/rayCastStereoLDI.glsl:321-450): both views' ray
marches run as dense array programs sharing the output grid; the
baseline-projection weight, the sequential occlusion fill, and the
front-to-back LDI compositing are elementwise selects.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .. import backend as _backend
from ..core.color import linear_to_srgb
from ..core.transforms import mat_from_focal, mm
from .raycast import (
    NUM_STEPS,
    _pixel_grid,
    blend_background,
    build_fskr2,
    build_skr1,
    raycast_layer,
)

__all__ = ["view_weight", "render_stereo"]


def view_weight(c, c1, c2):
    """Blend weight for the right view: the projection of the render camera
    onto the stereo baseline, smoothstepped to [0, 1].
    reference: rayCastStereoLDI.glsl:165-170."""
    d = c2 - c1
    den = jnp.sum(d * d, axis=-1)
    # coincident views (degenerate baseline): weight 0 (all left) instead of
    # the NaN the raw formula would produce
    t = jnp.clip(
        jnp.sum(d * (c - c1), axis=-1) / jnp.maximum(den, 1e-12), 0.0, 1.0
    )
    t = jnp.where(den < 1e-12, 0.0, t)
    return t * t * (3.0 - 2.0 * t)


@functools.partial(
    jax.jit,
    static_argnames=(
        "out_w", "out_h", "num_layers", "num_steps", "to_srgb", "unroll"
    ),
)
def render_stereo(
    rgb_l,
    disp_l,
    mask_l,
    layer_res_l,
    invz_min_l,
    invz_max_l,
    focal_l,
    skew1_l,
    c1_l,
    rot1_l,
    rgb_r,
    disp_r,
    mask_r,
    layer_res_r,
    invz_min_r,
    invz_max_r,
    focal_r,
    skew1_r,
    c1_r,
    rot1_r,
    f2,
    skew2,
    background,
    out_w: int,
    out_h: int,
    num_layers: int,
    feathering=0.1,
    num_steps: int = NUM_STEPS,
    to_srgb: bool = True,
    unroll: bool | None = None,
):
    """Render a novel view blending two source projectors (L and R).

    Per layer (reference: rayCastStereoLDI.glsl:368-436):
      1. raycast both views with the stereo mask semantics (3x3 dilated
         hard discard);
      2. occlusion fill, sequentially: L is replaced by R when L's
         confidence died and R's survived, or when L's alpha is notably
         lower (> 0.1); then the symmetric test for R reads the
         possibly-already-filled L (the GLSL's aliasing);
      3. blend (1-wR)*L + wR*R with wR from :func:`view_weight`;
      4. front-to-back over-composite across layers, then background blend
         and the final gamma.

    Inputs mirror :func:`lif_tpu.ops.raycast.render_mono`, duplicated per
    view. invz ranges must already be baseline-normalized. Returns
    (H, W, 4), GL-oriented.
    """
    if unroll is None:
        unroll = _backend.raycast_unroll(num_steps)
    s2x, s2y = _pixel_grid(out_w, out_h)
    fskr2 = build_fskr2(f2, float(out_w), float(out_h), skew2)
    c2 = jnp.zeros(3, dtype=jnp.float32)
    background = jnp.asarray(background, dtype=jnp.float32)

    skr1_l = build_skr1(skew1_l, rot1_l)
    skr1_r = build_skr1(skew1_r, rot1_r)
    w_r = view_weight(c2, c1_l.astype(jnp.float32), c1_r.astype(jnp.float32))

    res_l = layer_res_l.astype(jnp.float32)
    res_r = layer_res_r.astype(jnp.float32)

    def cast(view_rgb, view_disp, view_mask, res, izmin, izmax, focal, skr1, c1, i):
        fskr1 = mm(mat_from_focal(focal[i] / res[i, 0], focal[i] / res[i, 1]), skr1)
        return raycast_layer(
            s2x,
            s2y,
            fskr1,
            c1.astype(jnp.float32),
            fskr2,
            c2,
            view_rgb[i],
            view_disp[i],
            view_mask[i],
            izmin[i],
            izmax[i],
            res[i, 0],
            res[i, 1],
            background[:3],
            feathering,
            num_steps=num_steps,
            mask_mode="dilated_discard",
            unroll=unroll,
        )

    result_rgb = None
    result_a = None
    for i in range(num_layers):
        rgba_l, _, a_l = cast(
            rgb_l, disp_l, mask_l, res_l, invz_min_l, invz_max_l, focal_l,
            skr1_l, c1_l, i,
        )
        rgba_r, _, a_r = cast(
            rgb_r, disp_r, mask_r, res_r, invz_min_r, invz_max_r, focal_r,
            skr1_r, c1_r, i,
        )
        # Occlusion fill, sequential like the GLSL (:372-381): the R test
        # reads the possibly-already-filled L layer.
        fill_l = ((a_l == 0.0) & (a_r == 1.0)) | (
            rgba_l[..., 3] < rgba_r[..., 3] - 0.1
        )
        rgba_l2 = jnp.where(fill_l[..., None], rgba_r, rgba_l)
        fill_r = ((a_r == 0.0) & (a_l == 1.0)) | (
            rgba_r[..., 3] < rgba_l2[..., 3] - 0.1
        )
        rgba_r2 = jnp.where(fill_r[..., None], rgba_l2, rgba_r)

        layer = (1.0 - w_r) * rgba_l2 + w_r * rgba_r2
        la = layer[..., 3]
        if result_rgb is None:
            result_rgb = layer[..., :3] * la[..., None]
            result_a = la
        else:
            result_rgb = result_rgb + (1.0 - result_a[..., None]) * la[..., None] * layer[..., :3]
            result_a = la + result_a * (1.0 - la)

    result_rgb, result_a = blend_background(result_rgb, result_a, background)
    if to_srgb:
        result_rgb = linear_to_srgb(result_rgb)
    return jnp.concatenate([result_rgb, result_a[..., None]], axis=-1)
