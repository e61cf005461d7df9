"""Per-pixel inverse-depth ray-march kernel (the novel-view workhorse).

A JAX re-design of the reference's raycast fragment shader
(reference: src/shaders/rayCastMonoLDI.glsl:219-381). Instead of a fragment
program per pixel, the whole output image is computed as dense (H, W)
arrays: a 40-step loop (rolled or unrolled, backend.raycast_unroll)
carries the march state for every pixel simultaneously, each step
performing one bilinear gather of the disparity texture. Layers are
vmapped; compositing is a short unrolled over-operator chain.

Conventions (all faithful to the reference):
  * s2 = uv - 0.5, uv in [0,1]^2 GL-oriented (v up).
  * source transform FSKR1 = focal(f1/iRes) @ skew(sk1) @ flipZ R1^T flipZ,
    target FSKR2 = focal(f2/oRes) @ skew(sk2) @ flipZ R2^T flipZ.
  * P = FSKR1 @ inv(FSKR2), C = FSKR1 @ (C2 - C1); the source coordinate of
    the ray at inverse depth invZ is
    s1(invZ) = C.xy*invZ + (1 - C.z*invZ) * (Pxyxy s2 + Pxyz)/(Pzxy.s2 + Pzz).
  * March from invZmin toward invZmax in 40 linear steps; on surface
    crossing (disp > invZ && invZ2 > 0) step back and halve the step
    (fused march + binary refinement).
  * invZ values are in baseline-normalized units (caller divides the LIF
    inverse-depth range by the baseline; reference RaycastPlane.ts:476-478).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .composite import smoothstep as _smoothstep

from .. import backend as _backend
from ..core.color import linear_to_srgb
from ..core.transforms import inv3, mat_from_focal, mat_from_skew, mm, shader_rotation
from .sampling import bilinear_sample, read_disp

__all__ = [
    "NUM_STEPS",
    "MAX_LAYERS",
    "taper",
    "build_skr1",
    "build_fskr2",
    "raycast_layer",
    "render_mono",
]

NUM_STEPS = 40  # reference: rayCastMonoLDI.glsl:223
MAX_LAYERS = 4  # reference: RaycastPlane.ts:218


def taper(u, v, feathering):
    """Edge feathering window. reference: rayCastMonoLDI.glsl:49-53."""
    f = jnp.maximum(feathering, 1e-6)
    return (
        _smoothstep(0.0, f, u)
        * (1.0 - _smoothstep(1.0 - f, 1.0, u))
        * _smoothstep(0.0, f, v)
        * (1.0 - _smoothstep(1.0 - f, 1.0, v))
    )


def build_skr1(skew1, rot1):
    """Skew+rotation part of the source transform (focal applied per layer).
    reference: rayCastMonoLDI.glsl:316-326."""
    return mm(mat_from_skew(skew1[0], skew1[1]), shader_rotation(rot1))


def build_fskr2(f2, out_w, out_h, skew2, rot2=None):
    """Full target transform. reference: rayCastMonoLDI.glsl:332."""
    m = mm(mat_from_focal(f2 / out_w, f2 / out_h), mat_from_skew(skew2[0], skew2[1]))
    if rot2 is not None:
        m = mm(m, shader_rotation(rot2))
    return m


@functools.partial(
    jax.jit,
    static_argnames=("num_steps", "mask_mode", "unroll"),
)
def raycast_layer(
    s2x,
    s2y,
    fskr1,
    c1,
    fskr2,
    c2,
    rgb,
    disp,
    mask,
    invz_min,
    invz_max,
    res_w,
    res_h,
    background_rgb,
    feathering,
    t=1.0,
    num_steps: int = NUM_STEPS,
    mask_mode: str = "multiply",
    unroll: bool = False,
):
    """Ray-march one source layer for every output pixel.

    Batch-polymorphic: ``fskr1``/``fskr2`` may carry leading batch dims
    (..., 3, 3) and ``c1``/``c2`` (..., 3); the march state then broadcasts
    to (..., H, W) and each texture read remains ONE flat gather (vmap
    would instead produce a batched-gather lowering — batch by
    broadcasting, not by vmap).

    Args:
      s2x, s2y: (H, W) target coordinates (uv - 0.5), GL-oriented.
      fskr1: (..., 3, 3) full source transform (focal included).
      c1: (..., 3) source camera position (camera-local, Z-negated).
      fskr2: (..., 3, 3) full target transform.
      c2: (..., 3) render camera position in the same frame (usually zeros).
      rgb: (Hs, Ws, 3) linear-light source colors.
      disp: (Hs, Ws) disparity texture in [0, 1].
      mask: (Hs, Ws) layer mask in [0, 1] (1 everywhere for maskless layers).
      invz_min, invz_max: scalar baseline-normalized inverse-depth range.
      res_w, res_h: logical layer resolution (traced scalars ok).
      background_rgb: (3,) returned in the miss branch (alpha 0).
      feathering: edge taper width.
      t: animation parameter; hit requires invZ > invZmin*(1-t).
      mask_mode: 'multiply' -> alpha *= bilinear mask (mono LDI,
        rayCastMonoLDI.glsl:291); 'dilated_discard' -> 3x3 dilated hard
        discard (stereo, rayCastStereoLDI.glsl:304-305); 'none' -> taper
        only (non-LDI, rayCastMonoLDI.glsl:277-279).

    Returns:
      rgba: (..., H, W, 4) premultiplication NOT applied (matches the GLSL
        raycasting() return; compositing premultiplies).
      invz2: (..., H, W) inverse depth of the hit in target space (0 on miss).
      confidence: (..., H, W) the shader's confidence out-param.
    """
    dtype = jnp.float32
    s2x = s2x.astype(dtype)
    s2y = s2y.astype(dtype)

    p = mm(fskr1, inv3(fskr2))
    fskr1_b = jnp.broadcast_to(fskr1, p.shape)
    c = jnp.matmul(
        fskr1_b, (c2 - c1)[..., None], precision=jax.lax.Precision.HIGHEST
    )[..., 0]

    def bc(x):
        # (...,) scalar field -> (..., 1, 1) broadcastable against (H, W)
        return jnp.asarray(x, dtype)[..., None, None]

    # Block decomposition. reference: rayCastMonoLDI.glsl:244-247.
    p00, p01, p02 = bc(p[..., 0, 0]), bc(p[..., 0, 1]), bc(p[..., 0, 2])
    p10, p11, p12 = bc(p[..., 1, 0]), bc(p[..., 1, 1]), bc(p[..., 1, 2])
    p20, p21, p22 = bc(p[..., 2, 0]), bc(p[..., 2, 1]), bc(p[..., 2, 2])
    c_x, c_y, c_z = bc(c[..., 0]), bc(c[..., 1]), bc(c[..., 2])

    denom = p20 * s2x + p21 * s2y + p22  # Pzxy.s2 + Pzz -> (..., H, W)
    qx = (p00 * s2x + p01 * s2y + p02) / denom
    qy = (p10 * s2x + p11 * s2y + p12) / denom

    numsteps = jnp.asarray(num_steps, dtype)
    invz0 = invz_min
    dinvz0 = (invz_min - invz_max) / numsteps
    invz_min_t = invz0 * (1.0 - t)
    invz = jnp.full_like(denom, invz0 + dinvz0)  # step back once before start
    dinvz = jnp.full_like(denom, dinvz0)

    grad_thr = 0.02 * (invz_min - invz_max) * 140.0 / numsteps

    s1x = c_x * invz + (1.0 - c_z * invz) * qx
    s1y = c_y * invz + (1.0 - c_z * invz) * qy
    ds1x = (c_x - c_z * qx) * dinvz
    ds1y = (c_y - c_z * qy) * dinvz

    confidence = jnp.ones_like(denom)
    invz2 = jnp.zeros_like(denom)
    old_disp = jnp.zeros_like(denom)

    def body(carry):
        invz, s1x, s1y, dinvz, ds1x, ds1y, old_disp, invz2, confidence = carry
        invz = invz - dinvz
        s1x = s1x - ds1x
        s1y = s1y - ds1y

        disp_v = read_disp(disp, s1x + 0.5, s1y + 0.5, invz_min, invz_max, res_w, res_h)
        grad_disp = disp_v - old_disp
        old_disp = disp_v
        invz2 = invz * denom / (1.0 - c_z * invz)

        below = (disp_v > invz) & (invz2 > 0.0)
        confidence = jnp.where(
            below & (jnp.abs(grad_disp) > grad_thr), 0.0, confidence
        )
        invz = jnp.where(below, invz + dinvz, invz)
        s1x = jnp.where(below, s1x + ds1x, s1x)
        s1y = jnp.where(below, s1y + ds1y, s1y)
        dinvz = jnp.where(below, dinvz * 0.5, dinvz)
        ds1x = jnp.where(below, ds1x * 0.5, ds1x)
        ds1y = jnp.where(below, ds1y * 0.5, ds1y)
        return (invz, s1x, s1y, dinvz, ds1x, ds1y, old_disp, invz2, confidence)

    carry = (invz, s1x, s1y, dinvz, ds1x, ds1y, old_disp, invz2, confidence)
    if unroll:
        for _ in range(num_steps):
            carry = body(carry)
    else:
        carry = jax.lax.fori_loop(0, num_steps, lambda _, c: body(c), carry)
    (invz, s1x, s1y, dinvz, ds1x, ds1y, old_disp, invz2, confidence) = carry

    # Hit validity. Mono uses invZ2 > 0, stereo uses >= 0
    # (rayCastMonoLDI.glsl:275 vs rayCastStereoLDI.glsl:298).
    if mask_mode == "dilated_discard":
        invz2_ok = invz2 >= 0.0
    else:
        invz2_ok = invz2 > 0.0
    hit = (
        (jnp.abs(s1x) < 0.5)
        & (jnp.abs(s1y) < 0.5)
        & invz2_ok
        & (invz > invz_min_t)
    )

    u1 = s1x + 0.5
    v1 = s1y + 0.5
    color = bilinear_sample(rgb, u1, v1, res_w, res_h)
    tap = taper(u1, v1, feathering)

    if mask_mode == "multiply":
        mask_v = bilinear_sample(mask, u1, v1, res_w, res_h)
        alpha = tap * mask_v
        hit_confidence = tap
    elif mask_mode == "dilated_discard":
        # isMaskAround: 3x3 neighbourhood at 1.5-texel dilation, any sample
        # below 0.5 discards the hit. reference: rayCastStereoLDI.glsl:147-158.
        dilation = 1.5
        masked = jnp.zeros_like(u1, dtype=bool)
        for dy in (-1.0, 0.0, 1.0):
            for dx in (-1.0, 0.0, 1.0):
                mv = bilinear_sample(
                    mask,
                    u1 + dilation * dx / res_w,
                    v1 + dilation * dy / res_h,
                    res_w,
                    res_h,
                )
                masked = masked | (mv < 0.5)
        alpha = jnp.where(masked, 0.0, tap)
        color = jnp.where(masked[..., None], 0.0, color)
        hit_confidence = confidence  # stereo raycasting leaves confidence
    elif mask_mode == "none":
        alpha = tap
        hit_confidence = confidence
    else:
        raise ValueError(f"unknown mask_mode: {mask_mode}")

    bg = jnp.broadcast_to(background_rgb, color.shape)
    out_rgb = jnp.where(hit[..., None], color, bg)
    out_a = jnp.where(hit, alpha, 0.0)
    out_invz2 = jnp.where(hit, invz2, 0.0)
    if mask_mode == "dilated_discard":
        out_confidence = hit_confidence  # miss branch leaves confidence
    else:
        out_confidence = jnp.where(hit, hit_confidence, 0.0)

    rgba = jnp.concatenate([out_rgb, out_a[..., None]], axis=-1)
    return rgba, out_invz2, out_confidence


def _pixel_grid(out_w, out_h, dtype=jnp.float32, full_w=None, full_h=None,
                row_start=0, col_start=0):
    """GL-oriented pixel-center uv grid minus 0.5 (the s2 coordinates).

    With ``full_w``/``full_h`` set, produces the (out_h, out_w) tile of the
    larger (full_h, full_w) grid starting at (row_start, col_start) — the
    basis for sharding the output image across devices (each device renders
    its tile of the same virtual framebuffer)."""
    fw = out_w if full_w is None else full_w
    fh = out_h if full_h is None else full_h
    u = (jnp.arange(out_w, dtype=dtype) + 0.5 + col_start) / fw
    v = (jnp.arange(out_h, dtype=dtype) + 0.5 + row_start) / fh
    s2x = jnp.broadcast_to(u[None, :], (out_h, out_w)) - 0.5
    s2y = jnp.broadcast_to(v[:, None], (out_h, out_w)) - 0.5
    return s2x, s2y


def compose_layers(layers_rgba, num_layers):
    """Front-to-back over-compositing of raycast layers.

    reference: rayCastMonoLDI.glsl:338-358. The shader's early-outs
    (result.a == 1) are pure optimizations: blending a further layer into a
    saturated result is the identity, so an unconditional chain is exact.

    Args:
      layers_rgba: (L, H, W, 4), straight (non-premultiplied) alpha.
      num_layers: static int, number of valid layers.
    Returns (H, W, 3) premultiplied rgb and (H, W) alpha.
    """
    first = layers_rgba[0]
    out_rgb = first[..., :3] * first[..., 3:4]
    out_a = first[..., 3]
    for i in range(1, num_layers):
        layer = layers_rgba[i]
        la = layer[..., 3]
        out_rgb = out_rgb + (1.0 - out_a[..., None]) * la[..., None] * layer[..., :3]
        out_a = la + out_a * (1.0 - la)
    return out_rgb, out_a


def blend_background(rgb, alpha, background):
    """Blend the composited result over the background colour.
    reference: rayCastMonoLDI.glsl:361-362."""
    bg_rgb = background[:3]
    bg_a = background[3]
    out_rgb = bg_rgb * bg_a * (1.0 - alpha[..., None]) + rgb
    out_a = bg_a + alpha * (1.0 - bg_a)
    return out_rgb, out_a


@functools.partial(
    jax.jit,
    static_argnames=(
        "out_w", "out_h", "num_layers", "num_steps", "mask_mode", "to_srgb",
        "unroll", "full_w", "full_h",
    ),
)
def render_mono(
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
    feathering=0.1,
    ires_original=None,
    num_steps: int = NUM_STEPS,
    mask_mode: str = "multiply",
    to_srgb: bool = True,
    unroll: bool | None = None,
    full_w: int | None = None,
    full_h: int | None = None,
    row_start=0,
    col_start=0,
):
    """Render a novel view of one (possibly multi-layer) projector.

    ``full_w``/``full_h``/``row_start``/``col_start`` render an
    (out_h, out_w) TILE of a larger virtual framebuffer — the unit of
    image-space sharding (see lif_tpu.parallel).

    Pure function mirroring rayCastMonoLDI's main() (reference
    rayCastMonoLDI.glsl:299-381): per-layer ray march, front-to-back LDI
    compositing, background blend, optional linear->sRGB.

    Args:
      rgb: (L, Hs, Ws, 3) linear-light layer colours (padded to common size).
      disp: (L, Hs, Ws) disparity textures.
      mask: (L, Hs, Ws) masks (ones when absent).
      layer_res: (L, 2) logical (w, h) per layer.
      invz_min/invz_max: (L,) baseline-normalized inverse-depth range.
      focal: (L,) focal length in source pixels.
      skew1: (2,) source frustum skew (sk1).
      c1: (3,) projector position, camera-local with Z negated.
      rot1: (3, 3) projector rotation, camera-local.
      f2: render camera focal in output pixels.
      skew2: (2,) render camera frustum skew (sk2).
      background: (4,) linear-light background RGBA.
      out_w/out_h: output resolution (static).
      num_layers: static layer count (<= L).
      ires_original: optional (2,) aspect-window source size in output-pixel
        units; None disables the window (the reference's desktop path sets
        iResOriginal == oRes, which is a no-op window).
      mask_mode: see :func:`raycast_layer`.
      to_srgb: apply the final gamma curve.

    Returns (H, W, 4) GL-oriented image (row 0 = bottom).
    """
    if unroll is None:
        unroll = _backend.raycast_unroll(num_steps)
    s2x, s2y = _pixel_grid(
        out_w, out_h, full_w=full_w, full_h=full_h,
        row_start=row_start, col_start=col_start,
    )
    skr1 = build_skr1(skew1, rot1)
    # focal normalization always uses the FULL framebuffer dims (f2/oRes);
    # out_w/out_h may be just a tile of it
    fb_w = float(out_w if full_w is None else full_w)
    fb_h = float(out_h if full_h is None else full_h)
    fskr2 = build_fskr2(f2, fb_w, fb_h, skew2)
    c2 = jnp.zeros(3, dtype=jnp.float32)
    background = jnp.asarray(background, dtype=jnp.float32)

    # Unrolled python loop over the (static, <= 4) layers: batching the
    # texture gathers with vmap forces XLA into a batched-gather
    # lowering; unbatched gathers stay plain flat takes. The
    # sequential structure also mirrors the shader's layer chain
    # (rayCastMonoLDI.glsl:338-358).
    layer_res_f = layer_res.astype(jnp.float32)
    layers_rgba = []
    for i in range(num_layers):
        fskr1 = mm(
            mat_from_focal(focal[i] / layer_res_f[i, 0], focal[i] / layer_res_f[i, 1]),
            skr1,
        )
        rgba_i, _, _ = raycast_layer(
            s2x,
            s2y,
            fskr1,
            c1.astype(jnp.float32),
            fskr2,
            c2,
            rgb[i],
            disp[i],
            mask[i],
            invz_min[i],
            invz_max[i],
            layer_res_f[i, 0],
            layer_res_f[i, 1],
            background[:3],
            feathering,
            num_steps=num_steps,
            mask_mode=mask_mode,
            unroll=unroll,
        )
        layers_rgba.append(rgba_i)
    layers_rgba = jnp.stack(layers_rgba, axis=0)

    out_rgb, out_a = compose_layers(layers_rgba, num_layers)
    out_rgb, out_a = blend_background(out_rgb, out_a, background)

    if to_srgb:
        out_rgb = linear_to_srgb(out_rgb)

    image = jnp.concatenate([out_rgb, out_a[..., None]], axis=-1)

    if ires_original is not None:
        # Aspect-fit window. reference: rayCastMonoLDI.glsl:308-311.
        o_res = jnp.array([fb_w, fb_h], dtype=jnp.float32)
        s = jnp.minimum(o_res[0], o_res[1]) / jnp.minimum(
            ires_original[0], ires_original[1]
        )
        new_dim = ires_original * s / o_res
        inside = (jnp.abs(s2x) < 0.5 * new_dim[0]) & (jnp.abs(s2y) < 0.5 * new_dim[1])
        bg_out = background
        if to_srgb:
            bg_out = jnp.concatenate(
                [linear_to_srgb(background[:3]), background[3:]], axis=0
            )
        image = jnp.where(inside[..., None], image, bg_out)

    return image
