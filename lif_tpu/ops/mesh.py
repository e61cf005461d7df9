"""Connected-mesh triangle rasterizer: the reference's default render mode.

The JAX equivalent of the reference's connected-mesh path (reference:
src/shaders/holoVertex.glsl:68-102 corner depths, :155-163 corner
unprojection, :192-229 gradient cull; topology from
src/HoloRenderer.ts:809-858 — a (W+1)x(H+1) corner grid, each pixel quad
split into triangles (TL, BL, TR) and (TR, BL, BR)).

Instead of a vertex/fragment pipeline this is expressed as dense array
math plus a candidate-offset scatter rasterizer:

  1. Corner DEPTHS are the mean of the <=4 adjacent decoded pixel-center
     depths (edge-clamped) — exactly sampleAveragedDepth. Corner COLORS
     are the matching 4-pixel average: the GLSL fetches the RGB texture
     bilinearly AT the corner UV (holoVertex.glsl:180 with uv at pixel
     corners), which on a clamped texture IS that 4-pixel average, and the
     GPU then interpolates vColor across each triangle — so barycentric
     interpolation of corner-averaged colors reproduces the reference's
     shading exactly (perspective-correct, like the GPU's).
  2. Corners are unprojected with the corner coordinate (no +0.5), taken
     through the relative pose, and projected into the target pinhole.
  3. Every triangle is rasterized over a static max_quad_px x max_quad_px
     candidate window anchored at its screen bbox: edge-function coverage,
     perspective-correct attribute interpolation, then the splat.py
     two-pass z-buffer (scatter-min depth key, deterministic candidate-id
     resolve, masked color add). Pixel quads whose projection exceeds the
     candidate window are the extreme "stretch-mark" triangles spanning
     depth discontinuities; they are culled (the gradient cull exists to
     remove exactly those — set delta_invz_threshold for
     reference-faithful control of them).

A quad's projected footprint is bounded by ~magnification x 1 px for
surface quads, so max_quad_px=4 covers up to ~3x magnification before
surface quads start being culled (raise it, at S^2 scatter cost, for
extreme close-ups).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..core.color import linear_to_srgb

__all__ = ["render_connected_mesh", "render_mesh_connected_view"]

EPSILON = 1e-8  # reference: holoVertex.glsl:44
INF_Z = 1e6  # reference: holoVertex.glsl:45


def _decode_depth(disp, invz_min, invz_max, baseline):
    """texel -> depth (reference: holoVertex.glsl:57-64)."""
    invz = invz_max + (invz_min - invz_max) * disp
    return jnp.where(jnp.abs(invz) < EPSILON, INF_Z, baseline / invz)


def _corner_average(field):
    """(H, W, ...) pixel-center field -> (H+1, W+1, ...) corner field:
    mean of the <=4 adjacent pixels, edge-clamped
    (reference: holoVertex.glsl:68-102)."""
    pad = [(1, 1), (1, 1)] + [(0, 0)] * (field.ndim - 2)
    f = jnp.pad(field, pad, mode="edge")
    return 0.25 * (
        f[:-1, :-1] + f[:-1, 1:] + f[1:, :-1] + f[1:, 1:]
    )


@functools.partial(
    jax.jit,
    static_argnames=("out_w", "out_h", "max_quad_px", "to_srgb", "show_depth"),
)
def render_connected_mesh(
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
    max_quad_px: int = 4,
    to_srgb: bool = True,
    show_depth=False,
):
    """Rasterize one source layer as a connected triangle mesh.

    Args:
      rgb: (H, W, 3) linear source colors, GL-oriented.
      disp: (H, W) normalized inverse depth.
      invz_min/invz_max/baseline: depth decode parameters (LIF units).
      fx, fy, cx, cy: source intrinsics in pixels (GL-oriented cy).
      rel_rotation: (3, 3) camera-local projector rotation.
      rel_position: (3,) camera-local projector position, scene convention
        (-Z forward).
      f2: target focal in pixels (centered principal point).
      background: (4,) linear RGBA for unhit pixels.
      delta_invz_threshold: per-vertex gradient cull — drop vertices whose
        5-sample invZ neighbourhood range exceeds this, which removes the
        triangles using them (reference: holoVertex.glsl:192-229);
        0 disables.
      max_quad_px: static candidate window; quads projecting larger are
        culled (see module docstring).
      show_depth: depth-visualization shading (holoFragment.glsl:39-44).

    Returns (out_h, out_w, 4), GL-oriented.
    """
    h, w = disp.shape
    dtype = jnp.float32
    disp = disp.astype(dtype)
    S = max_quad_px

    depth = _decode_depth(disp, invz_min, invz_max, baseline)
    cdepth = _corner_average(depth)  # (H+1, W+1)
    ccolor = _corner_average(rgb.astype(dtype))  # (H+1, W+1, 3)
    if show_depth:
        ccolor = jnp.repeat(_corner_average(disp)[..., None], 3, axis=-1)

    # Corner unprojection at the corner coordinate (no +0.5).
    # reference: holoVertex.glsl:155-163.
    gx = jnp.arange(w + 1, dtype=dtype)[None, :]
    gy = jnp.arange(h + 1, dtype=dtype)[:, None]
    x_cam = (gx - cx) * cdepth / fx
    y_cam = (gy - cy) * cdepth / fy
    z_cam = -cdepth

    r = rel_rotation.astype(dtype)
    t = rel_position.astype(dtype)
    xv = r[0, 0] * x_cam + r[0, 1] * y_cam + r[0, 2] * z_cam + t[0]
    yv = r[1, 0] * x_cam + r[1, 1] * y_cam + r[1, 2] * z_cam + t[1]
    zv = r[2, 0] * x_cam + r[2, 1] * y_cam + r[2, 2] * z_cam + t[2]

    vvalid = zv < -0.001  # reference: holoVertex.glsl:187-189

    if delta_invz_threshold is not None:
        # per-vertex 5-sample invz range at pixel (int corner coords,
        # edge-clamped). reference: holoVertex.glsl:192-229.
        invz_tex = invz_max + (invz_min - invz_max) * disp
        p = jnp.pad(invz_tex, 1, mode="edge")
        neigh = jnp.stack(
            [invz_tex, p[1:-1, :-2], p[1:-1, 2:], p[:-2, 1:-1], p[2:, 1:-1]]
        )
        delta = jnp.max(neigh, axis=0) - jnp.min(neigh, axis=0)
        # corner (i, j) -> pixel (min(i, H-1), min(j, W-1)) == edge pad
        delta_c = jnp.pad(delta, ((0, 1), (0, 1)), mode="edge")
        thr = jnp.asarray(delta_invz_threshold, dtype)
        vvalid = vvalid & ((thr <= 0.0) | (delta_c <= thr))

    # Perspective projection; q = 1/w (positive in front of the camera).
    q = 1.0 / jnp.maximum(-zv, 1e-9)
    u = f2 * xv * q + out_w / 2.0
    v = f2 * yv * q + out_h / 2.0

    def gv(a, di, dj):  # corner grid -> per-quad vertex arrays (H, W, ...)
        return a[di : di + h, dj : dj + w]

    # quad corners: TL=(i,j) TR=(i,j+1) BL=(i+1,j) BR=(i+1,j+1);
    # triangles (TL, BL, TR) and (TR, BL, BR). HoloRenderer.ts:842-848.
    tris = (
        ((0, 0), (1, 0), (0, 1)),
        ((0, 1), (1, 0), (1, 1)),
    )

    n_out = out_h * out_w
    n_cand = h * w * len(tris) * S * S
    zbuf = jnp.full((n_out,), jnp.inf, dtype)
    idbuf = jnp.full((n_out,), jnp.int32(2**31 - 1), jnp.int32)
    bg = jnp.asarray(background, dtype)

    def tri_arrays(tri):
        us = [gv(u, *c) for c in tri]
        vs = [gv(v, *c) for c in tri]
        qs = [gv(q, *c) for c in tri]
        cs = [gv(ccolor, *c) for c in tri]
        ok = gv(vvalid, *tri[0]) & gv(vvalid, *tri[1]) & gv(vvalid, *tri[2])
        return us, vs, qs, cs, ok

    def candidates(tri_idx, us, vs, ok):
        """Anchor + validity for the S x S candidate window of each tri."""
        umin = jnp.minimum(jnp.minimum(us[0], us[1]), us[2])
        umax = jnp.maximum(jnp.maximum(us[0], us[1]), us[2])
        vmin = jnp.minimum(jnp.minimum(vs[0], vs[1]), vs[2])
        vmax = jnp.maximum(jnp.maximum(vs[0], vs[1]), vs[2])
        fits = (umax - umin < S) & (vmax - vmin < S)
        # first pixel center >= umin: floor(umin - 0.5) + 1
        iu0 = jnp.floor(umin - 0.5).astype(jnp.int32) + 1
        iv0 = jnp.floor(vmin - 0.5).astype(jnp.int32) + 1
        return iu0, iv0, ok & fits

    def cover(us, vs, px, py):
        """Edge-function barycentrics at pixel center (px, py)."""
        ax, ay, bx, by, cx_, cy_ = us[0], vs[0], us[1], vs[1], us[2], vs[2]
        area = (bx - ax) * (cy_ - ay) - (by - ay) * (cx_ - ax)
        w0 = (cx_ - bx) * (py - by) - (cy_ - by) * (px - bx)
        w1 = (ax - cx_) * (py - cy_) - (ay - cy_) * (px - cx_)
        w2 = (bx - ax) * (py - ay) - (by - ay) * (px - ax)
        denom = jnp.where(jnp.abs(area) < 1e-12, 1.0, area)
        l0, l1, l2 = w0 / denom, w1 / denom, w2 / denom
        # small negative tolerance: a pixel center exactly on the shared
        # quad diagonal must not fall through BOTH triangles to f32
        # rounding (the z-resolve already picks a unique winner, so the
        # resulting double coverage on shared edges is benign)
        eps = -1e-4
        inside = (
            (jnp.abs(area) > 1e-12)
            & (l0 >= eps) & (l1 >= eps) & (l2 >= eps)
        )
        return inside, (l0, l1, l2)

    # pass 1: z-buffer scatter-min (key = -q: nearer target surface has
    # larger q, like the GPU's NDC depth test which is monotone in 1/w)
    per_tri = []  # cached per-triangle arrays for the later passes
    for ti, tri in enumerate(tris):
        us, vs, qs, cs, ok = tri_arrays(tri)
        iu0, iv0, tok = candidates(ti, us, vs, ok)
        per_tri.append((us, vs, qs, cs, iu0, iv0, tok))
        for dy in range(S):
            for dx in range(S):
                px = iu0.astype(dtype) + dx + 0.5
                py = iv0.astype(dtype) + dy + 0.5
                inside, (l0, l1, l2) = cover(us, vs, px, py)
                qi = l0 * qs[0] + l1 * qs[1] + l2 * qs[2]
                pu = iu0 + dx
                pv = iv0 + dy
                inb = (pu >= 0) & (pu < out_w) & (pv >= 0) & (pv < out_h)
                live = tok & inside & inb & (qi > 0.0)
                fi = (
                    jnp.clip(pv, 0, out_h - 1) * out_w
                    + jnp.clip(pu, 0, out_w - 1)
                ).reshape(-1)
                key = jnp.where(live, -qi, jnp.inf).reshape(-1)
                zbuf = zbuf.at[fi].min(key, mode="drop")

    # pass 2: deterministic winner id (lowest candidate id among ties)
    tri_id = jnp.arange(h * w, dtype=jnp.int32).reshape(h, w)
    for ti, (us, vs, qs, cs, iu0, iv0, tok) in enumerate(per_tri):
        for dy in range(S):
            for dx in range(S):
                px = iu0.astype(dtype) + dx + 0.5
                py = iv0.astype(dtype) + dy + 0.5
                inside, (l0, l1, l2) = cover(us, vs, px, py)
                qi = l0 * qs[0] + l1 * qs[1] + l2 * qs[2]
                pu = iu0 + dx
                pv = iv0 + dy
                inb = (pu >= 0) & (pu < out_w) & (pv >= 0) & (pv < out_h)
                live = tok & inside & inb & (qi > 0.0)
                fi = (
                    jnp.clip(pv, 0, out_h - 1) * out_w
                    + jnp.clip(pu, 0, out_w - 1)
                ).reshape(-1)
                key = jnp.where(live, -qi, jnp.inf).reshape(-1)
                won = (key <= jnp.take(zbuf, fi)) & jnp.isfinite(key)
                cid = (
                    (tri_id * len(tris) + ti) * (S * S) + dy * S + dx
                ).reshape(-1)
                idbuf = idbuf.at[fi].min(
                    jnp.where(won, cid, jnp.int32(2**31 - 1)), mode="drop"
                )

    # pass 3: the unique winner writes its perspective-correct color
    out_rgb = jnp.zeros((n_out, 3), dtype)
    for ti, (us, vs, qs, cs, iu0, iv0, tok) in enumerate(per_tri):
        for dy in range(S):
            for dx in range(S):
                px = iu0.astype(dtype) + dx + 0.5
                py = iv0.astype(dtype) + dy + 0.5
                inside, (l0, l1, l2) = cover(us, vs, px, py)
                qi = l0 * qs[0] + l1 * qs[1] + l2 * qs[2]
                pu = iu0 + dx
                pv = iv0 + dy
                inb = (pu >= 0) & (pu < out_w) & (pv >= 0) & (pv < out_h)
                live = tok & inside & inb & (qi > 0.0)
                fi = (
                    jnp.clip(pv, 0, out_h - 1) * out_w
                    + jnp.clip(pu, 0, out_w - 1)
                ).reshape(-1)
                cid = (
                    (tri_id * len(tris) + ti) * (S * S) + dy * S + dx
                ).reshape(-1)
                sel = live.reshape(-1) & (jnp.take(idbuf, fi) == cid)
                # perspective-correct: c = sum(l c q) / sum(l q)
                qsafe = jnp.maximum(qi, 1e-12)
                col = (
                    l0[..., None] * cs[0] * qs[0][..., None]
                    + l1[..., None] * cs[1] * qs[1][..., None]
                    + l2[..., None] * cs[2] * qs[2][..., None]
                ) / qsafe[..., None]
                out_rgb = out_rgb.at[fi].add(
                    jnp.where(sel[:, None], col.reshape(-1, 3), 0.0),
                    mode="drop",
                )

    hit = idbuf < jnp.int32(2**31 - 1)
    rgb_img = jnp.where(hit[:, None], out_rgb, bg[:3] * bg[3])
    a_img = jnp.where(hit, 1.0, bg[3])
    if to_srgb:
        rgb_img = linear_to_srgb(rgb_img)
    return jnp.concatenate(
        [rgb_img.reshape(out_h, out_w, 3), a_img.reshape(out_h, out_w, 1)],
        axis=-1,
    )


def render_mesh_connected_view(
    projector,
    camera,
    background=(0.0, 0.0, 0.0, 0.0),
    delta_invz_threshold=0.0,
    max_quad_px: int = 4,
    to_srgb: bool = True,
    show_depth=False,
):
    """Connected-mesh render of a Projector into a Camera (layer 0, like
    the reference's mesh mode; HoloRenderer.ts:186-189)."""
    import numpy as np

    from ..core.pose import relative_view_pose

    pos, rot = relative_view_pose(
        np.asarray(projector.position, np.float64),
        np.asarray(projector.rotation, np.float64),
        np.asarray(camera.position, np.float64),
        np.asarray(camera.rotation, np.float64),
    )
    pos = pos * np.array([1.0, 1.0, -1.0])  # undo shader Z negation

    intr = projector.intrinsics
    cy_gl = projector.height - intr["cy"]

    return render_connected_mesh(
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
        max_quad_px=max_quad_px,
        to_srgb=to_srgb,
        show_depth=show_depth,
    )
