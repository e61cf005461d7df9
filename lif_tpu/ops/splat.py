"""Forward-warp splat renderer: the mesh/billboard path as a scatter
rasterizer.

The JAX equivalent of the reference's mesh render mode
(reference: src/shaders/holoVertex.glsl + holoFragment.glsl, geometry from
HoloRenderer.ts:809-858): every source pixel is unprojected with its
decoded depth, transformed into the target view, and splatted with a
square pixel footprint into a z-buffered image. Instead of a vertex/
fragment pipeline, this is: dense elementwise unproject/project math over
the source grid, scatter-min into a depth buffer, then a masked color
resolve — the depth-tested scatter rasterizer role from BASELINE.json's
north star, expressed with XLA scatter ops (segment-min) so it runs on
any backend.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..core.color import linear_to_srgb

__all__ = ["forward_splat", "render_mesh_view"]

EPSILON = 1e-8  # reference: holoVertex.glsl:44
INF_Z = 1e6  # reference: holoVertex.glsl:45


def _decode_depth(disp, invz_min, invz_max, baseline):
    """texel -> depth: invZ = mix(invZmax, invZmin, texel); depth =
    baseline/invZ; invZ ~ 0 => 1e6. reference: holoVertex.glsl:57-64."""
    invz = invz_max + (invz_min - invz_max) * disp
    return jnp.where(jnp.abs(invz) < EPSILON, INF_Z, baseline / invz)


@functools.partial(
    jax.jit,
    static_argnames=("out_w", "out_h", "footprint", "to_srgb", "show_depth"),
)
def forward_splat(
    rgb,
    disp,
    invz_min,
    invz_max,
    baseline,
    fx,
    fy,
    cx,
    cy,
    rel_rotation,
    rel_position,
    f2,
    out_w: int,
    out_h: int,
    background,
    delta_invz_threshold=0.0,
    point_size=1.0,
    footprint: int = 2,
    to_srgb: bool = True,
    show_depth=False,
):
    """Splat one source layer into a novel view with z-buffering.

    Args:
      rgb: (H, W, 3) linear source colors, GL-oriented.
      disp: (H, W) normalized inverse depth (Nearest-sampled semantics —
        the mesh path reads the raw depth texture, HoloProjector.ts:249).
      invz_min/invz_max/baseline: depth decode parameters (LIF units).
      fx, fy, cx, cy: source intrinsics in pixels (GL-oriented cy).
      rel_rotation: (3, 3) camera-local projector rotation (R_cam^T R_proj).
      rel_position: (3,) camera-local projector position, scene convention
        (-Z forward; NOT the shader's Z-negated form).
      f2: target focal in pixels.
      out_w/out_h: output size.
      background: (4,) linear RGBA for unhit pixels.
      delta_invz_threshold: optional gradient cull — drop pixels whose
        5-sample invZ neighbourhood range exceeds this
        (reference: holoVertex.glsl:192-229); 0 disables.
      point_size: footprint scale (reference: holoVertex.glsl:264).
      footprint: static splat kernel width in target pixels (square
        pixel footprints; BASELINE.json north star).
      show_depth: render the depth visualization instead of color
        (reference: holoFragment.glsl:39-44).

    Returns (out_h, out_w, 4), GL-oriented.
    """
    h, w = disp.shape
    dtype = jnp.float32
    disp = disp.astype(dtype)

    depth = _decode_depth(disp, invz_min, invz_max, baseline)

    # Pixel centers (i+0.5, j+0.5). reference: holoVertex.glsl:139,165-170.
    px = (jnp.arange(w, dtype=dtype) + 0.5)[None, :]
    py = (jnp.arange(h, dtype=dtype) + 0.5)[:, None]
    x_cam = (px - cx) * depth / fx
    y_cam = (py - cy) * depth / fy
    z_cam = -depth

    # projector -> camera-local: R_rel @ p + t_rel
    r = rel_rotation.astype(dtype)
    t = rel_position.astype(dtype)
    xv = r[0, 0] * x_cam + r[0, 1] * y_cam + r[0, 2] * z_cam + t[0]
    yv = r[1, 0] * x_cam + r[1, 1] * y_cam + r[1, 2] * z_cam + t[1]
    zv = r[2, 0] * x_cam + r[2, 1] * y_cam + r[2, 2] * z_cam + t[2]

    # Behind-camera discard. reference: holoVertex.glsl:187-189.
    valid = zv < -0.001

    # Optional gradient cull: invZ range over the 4-neighbourhood + centre.
    if delta_invz_threshold is not None:
        invz_tex = invz_max + (invz_min - invz_max) * disp
        pad = jnp.pad(invz_tex, 1, mode="edge")
        neigh = jnp.stack(
            [
                invz_tex,
                pad[1:-1, :-2],
                pad[1:-1, 2:],
                pad[:-2, 1:-1],
                pad[2:, 1:-1],
            ]
        )
        delta = jnp.max(neigh, axis=0) - jnp.min(neigh, axis=0)
        thr = jnp.asarray(delta_invz_threshold, dtype)
        valid = valid & ((thr <= 0.0) | (delta <= thr))

    # Project into the target pinhole (centered pp), pixel coords.
    inv_zv = 1.0 / jnp.minimum(zv, -1e-9)
    u = f2 * (xv * -inv_zv) + out_w / 2.0
    v = f2 * (yv * -inv_zv) + out_h / 2.0

    # Depth key for z-test: nearer (smaller |zv|) wins.
    zkey = jnp.where(valid, -zv, jnp.inf).reshape(-1)

    # Screen-space footprint: at distance d from the projector one source
    # pixel covers d/fx meters; projected through the target camera that is
    # (d/fx) * f2 / |zv| output pixels, scaled by point_size.
    # reference: holoVertex.glsl:252-264.
    dist = jnp.sqrt(x_cam**2 + y_cam**2 + z_cam**2)
    su = (dist / fx) * f2 * (-inv_zv) * point_size
    sv = (dist / fy) * f2 * (-inv_zv) * point_size

    n_out = out_h * out_w
    iu = jnp.floor(u - 0.5 * (footprint - 1)).astype(jnp.int32)
    iv = jnp.floor(v - 0.5 * (footprint - 1)).astype(jnp.int32)

    zbuf = jnp.full((n_out,), jnp.inf, dtype)
    offsets = [(dy, dx) for dy in range(footprint) for dx in range(footprint)]

    def splat_key(dy, dx):
        """Flat target index + depth key for one footprint offset; a target
        pixel is covered iff its center lies inside the projected quad
        (rasterization coverage)."""
        px_u = iu + dx
        px_v = iv + dy
        covered = (jnp.abs(px_u.astype(dtype) + 0.5 - u) <= jnp.maximum(su, 1.0) * 0.5) & (
            jnp.abs(px_v.astype(dtype) + 0.5 - v) <= jnp.maximum(sv, 1.0) * 0.5
        )
        inb = (px_u >= 0) & (px_u < out_w) & (px_v >= 0) & (px_v < out_h)
        uu = jnp.clip(px_u, 0, out_w - 1)
        vv = jnp.clip(px_v, 0, out_h - 1)
        fi = (vv * out_w + uu).reshape(-1)
        key = jnp.where((inb & covered).reshape(-1), zkey, jnp.inf)
        return fi, key

    idx_all = []
    for dy, dx in offsets:
        fi, key = splat_key(dy, dx)
        zbuf = zbuf.at[fi].min(key, mode="drop")
        idx_all.append((fi, key))

    # Color resolve with deterministic tie-breaking: among the sources that
    # match the z-buffer winner at a target pixel, the lowest source id
    # wins (a second scatter-min over ids), then ONE gather fetches its
    # color. This avoids blending artifacts at exact depth ties (e.g. flat
    # depth with overlapping footprints).
    n_src = h * w
    src_id = jnp.arange(n_src, dtype=jnp.int32)
    idbuf = jnp.full((n_out,), n_src, jnp.int32)
    for fi, key in idx_all:
        won = (key <= jnp.take(zbuf, fi)) & jnp.isfinite(key)
        idbuf = idbuf.at[fi].min(jnp.where(won, src_id, n_src), mode="drop")

    hit = idbuf < n_src
    win_id = jnp.clip(idbuf, 0, n_src - 1).reshape(-1)
    if show_depth:
        # Depth visualization: the winning depth texel as grayscale.
        # reference: holoFragment.glsl:39-44.
        gray = jnp.take(disp.reshape(-1), win_id)
        out_rgb = jnp.stack([gray] * 3, axis=-1)
    else:
        flat_rgb = rgb.reshape(-1, 3).astype(dtype)
        out_rgb = jnp.stack(
            [jnp.take(flat_rgb[:, c], win_id) for c in range(3)], axis=-1
        )

    background = jnp.asarray(background, dtype)
    rgb_img = jnp.where(hit[:, None], out_rgb, background[:3] * background[3])
    a_img = jnp.where(hit, 1.0, background[3])
    if to_srgb:
        rgb_img = linear_to_srgb(rgb_img)
    return jnp.concatenate(
        [rgb_img.reshape(out_h, out_w, 3), a_img.reshape(out_h, out_w, 1)],
        axis=-1,
    )


def render_mesh_view(
    projector,
    camera,
    background=(0.0, 0.0, 0.0, 0.0),
    delta_invz_threshold=0.0,
    point_size=1.0,
    footprint: int = 2,
    to_srgb: bool = True,
    show_depth=False,
):
    """Mesh-mode render of a Projector into a Camera (layer 0, like the
    reference which renders only the first projector/layer in mesh mode;
    HoloRenderer.ts:186-189)."""
    import numpy as np

    from ..core.pose import relative_view_pose

    pos, rot = relative_view_pose(
        np.asarray(projector.position, np.float64),
        np.asarray(projector.rotation, np.float64),
        np.asarray(camera.position, np.float64),
        np.asarray(camera.rotation, np.float64),
    )
    # relative_view_pose returns the shader-space Z-negated position;
    # the splat math works in scene convention, so undo the negation.
    pos = pos * np.array([1.0, 1.0, -1.0])

    intr = projector.intrinsics
    # GL-oriented cy: intrinsics are defined top-down (cy from the top);
    # flip to the bottom-origin frame the arrays use.
    cy_gl = projector.height - intr["cy"]

    return forward_splat(
        jnp.asarray(projector.rgb[0]),
        jnp.asarray(projector.disp[0]),
        jnp.asarray(projector.invz_min[0], jnp.float32),
        jnp.asarray(projector.invz_max[0], jnp.float32),
        jnp.asarray(projector.baseline, jnp.float32),
        jnp.asarray(intr["fx"], jnp.float32),
        jnp.asarray(intr["fy"], jnp.float32),
        jnp.asarray(intr["cx"], jnp.float32),
        jnp.asarray(cy_gl, jnp.float32),
        jnp.asarray(rot, jnp.float32),
        jnp.asarray(pos, jnp.float32),
        jnp.asarray(camera.focal_px, jnp.float32),
        out_w=camera.width,
        out_h=camera.height,
        background=jnp.asarray(background, jnp.float32),
        delta_invz_threshold=delta_invz_threshold,
        point_size=point_size,
        footprint=footprint,
        to_srgb=to_srgb,
        show_depth=show_depth,
    )
