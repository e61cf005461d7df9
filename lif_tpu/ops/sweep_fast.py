"""Gather-free fast renderer: matmul plane sweep for aligned views.

The legacy fallback tier: the exact ray march (ops/raycast.py) spends
40x4 gathers/pixel; this module renders the same scene with NO gathers
at all:

  * In a SOURCE-ALIGNED frame (target camera rotated to the projector's
    orientation, matched intrinsics), every inverse-depth plane's warp is a
    uniform scale+shift:  s1 = C.xy*invZ + (1 - C.z*invZ)*s2.
  * A uniform scale+shift resample is a banded linear operator per axis ->
    per-plane (W_out x W_in) and (H_out x H_in) bilinear matrices, applied
    as bf16 batched MATMULS.
  * Occupancy/compositing are elementwise, streamed over plane
    chunks so intermediates stay small.
  * Rotation is factored out exactly: a rotation about the camera center
    is a homography of the image plane, applied once at the end (or
    skipped when the relative rotation is identity).

Quality matches the soft sweep (ops/sweep.py), which matches the exact
march at >40 dB; edge semantics differ slightly (zero-pad vs clamp beyond
the source border).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .composite import smoothstep as _smoothstep

from ..core.color import linear_to_srgb

__all__ = ["render_sweep_aligned", "solve_depth_aligned", "render_rotated"]


def _axis_visibility(scale, shift_px, n_out, n_in, feathering):
    """Separable per-axis visibility: inside-the-source indicator times the
    feathering taper, evaluated at each output position's source uv.
    Returns (K, n_out)."""
    j = jnp.arange(n_out, dtype=jnp.float32)
    c_out = (n_out - 1) / 2.0
    c_in = (n_in - 1) / 2.0
    g = scale[:, None] * (j[None, :] - c_out) + c_in + shift_px[:, None]
    u = (g + 0.5) / n_in  # source uv in [0, 1]
    s = u - 0.5
    inside = (jnp.abs(s) < 0.5).astype(jnp.float32)
    f = jnp.maximum(feathering, 1e-6)
    tap = _smoothstep(0.0, f, u) * (1.0 - _smoothstep(1.0 - f, 1.0, u))
    return inside * tap


def _resample_matrices(
    scale, shift_px, n_out: int, n_in: int, dtype=jnp.bfloat16,
    clamp_lo: float = 0.0, clamp_hi: float | None = None,
):
    """Banded bilinear resample matrices for a batch of uniform maps.

    Row j of M holds the bilinear weights for output position
    g(j) = scale * (j - c_out) + c_in + shift_px (centers aligned), i.e.
    out = M @ src. scale/shift_px: (K,) arrays. Returns (K, n_out, n_in).

    clamp_lo/clamp_hi: sample-position clamp. Defaults to clamp-to-edge
    (GL semantics); the disparity texture uses the march's 2-texel interior
    clamp [1.5, n-2.5] (readDisp, rayCastMonoLDI.glsl:59-61).
    """
    j = jnp.arange(n_out, dtype=jnp.float32)
    c_out = (n_out - 1) / 2.0
    c_in = (n_in - 1) / 2.0
    g = scale[:, None] * (j[None, :] - c_out) + c_in + shift_px[:, None]
    g = jnp.clip(g, clamp_lo, (n_in - 1.0) if clamp_hi is None else clamp_hi)
    src = jnp.arange(n_in, dtype=jnp.float32)
    m = jnp.maximum(0.0, 1.0 - jnp.abs(g[:, :, None] - src[None, None, :]))
    return m.astype(dtype)


@functools.partial(
    jax.jit,
    static_argnames=(
        "out_w", "out_h", "num_planes", "chunk", "to_srgb", "exact_color"
    ),
)
def render_sweep_aligned(
    rgb,
    disp,
    mask,
    invz_min,
    invz_max,
    c1,
    f2,
    background,
    out_w: int,
    out_h: int,
    focal1=None,
    num_planes: int = 40,
    softness: float = 0.5,
    chunk: int = 8,
    feathering: float = 0.1,
    to_srgb: bool = True,
    plane_invz=None,
    exact_color: bool = False,
):
    """Render a translated (rotation-free) novel view without gathers.

    With no relative rotation or skew, the plane-k warp collapses to a
    uniform map in pixel space (any focal/resolution combination):

        scale_k  = (1 + c1.z * invZ_k) * f1 / f2
        shift_k  = -f1 * c1.xy * invZ_k       (pixels, both axes)

    Args:
      rgb: (H, W, 3) linear source colors, GL-oriented.
      disp: (H, W) normalized inverse depth.
      mask: (H, W) alpha mask (ones when absent).
      invz_min/invz_max: baseline-normalized inverse-depth range (scalars).
      c1: (3,) projector position in the camera frame, shader convention
        (Z negated) — the camera must share the projector's ORIENTATION
        (the aligned frame); position and focal may differ.
      f2: render-camera focal length in output pixels.
      focal1: source focal in source pixels (defaults to f2: matched
        intrinsics).
      background: (4,) linear RGBA.
      num_planes: inverse-depth planes swept near -> far.
      softness: occupancy sigmoid width as a fraction of the LOCAL plane
        spacing. ~0.5 gives sub-plane interpolation (the weighted blend of
        the two neighbouring plane warps linearly interpolates the parallax
        position); large values blur, tiny values snap to planes.
      chunk: planes per batched-matmul chunk (memory/compute balance).
      plane_invz: optional (num_planes,) inverse-depth plane positions,
        ordered near -> far (descending). Defaults to linear spacing over
        [invz_min, invz_max]; pass disparity QUANTILES of the depth map for
        scene-adaptive placement (concentrates planes where surfaces are —
        crucial when invz_min/invz_max spans orders of magnitude).

    Returns (out_h, out_w, 4), GL-oriented.
    """
    h, w = disp.shape
    izmin = jnp.asarray(invz_min, jnp.float32)
    izmax = jnp.asarray(invz_max, jnp.float32)
    c1 = jnp.asarray(c1, jnp.float32)
    f1 = jnp.asarray(f2 if focal1 is None else focal1, jnp.float32)
    f2 = jnp.asarray(f2, jnp.float32)

    if plane_invz is None:
        ks = (jnp.arange(num_planes, dtype=jnp.float32) + 0.5) / num_planes
        invz = izmin + (izmax - izmin) * ks  # near -> far
    else:
        invz = jnp.asarray(plane_invz, jnp.float32)
    b = 1.0 + c1[2] * invz  # per-plane uniform scale (C.z = -c1.z)
    scale = b * (f1 / f2)
    shift_x = -f1 * c1[0] * invz
    shift_y = -f1 * c1[1] * invz
    # per-plane sigmoid sharpness from the LOCAL spacing
    spacing = jnp.abs(jnp.diff(invz))
    spacing = jnp.concatenate([spacing[:1], spacing])  # (K,)
    sharp = 1.0 / jnp.maximum(spacing * softness, 1e-9)

    # texture stacks: rgb+mask warp in bf16 (color tolerance); disp warps in
    # f32 — its value feeds the occupancy sigmoid at sharpness ~400, where
    # bf16's ~2^-8 granularity would visibly quantize the surface
    tex4 = jnp.concatenate([rgb, mask[..., None]], axis=-1).astype(jnp.bfloat16)
    disp32 = disp.astype(jnp.float32)

    background = jnp.asarray(background, jnp.float32)
    n_chunks = (num_planes + chunk - 1) // chunk

    transmittance = jnp.ones((out_h, out_w), jnp.float32)
    acc_rgb = jnp.zeros((out_h, out_w, 3), jnp.float32)
    acc_a = jnp.zeros((out_h, out_w), jnp.float32)
    # exact_color first-crossing state
    found = jnp.zeros((out_h, out_w), bool)
    invz_star = jnp.zeros((out_h, out_w), jnp.float32)
    prev_diff = jnp.zeros((out_h, out_w), jnp.float32)
    prev_invz = jnp.zeros((out_h, out_w), jnp.float32)

    # (W, H*4) layout for the color row pass; (W, H) for the f32 disp pass
    tex_whc = tex4.transpose(1, 0, 2).reshape(w, h * 4)
    disp_wh = disp32.T  # (W, H)

    for ci in range(n_chunks):
        lo = ci * chunk
        hi = min(lo + chunk, num_planes)
        kb = hi - lo
        if not exact_color:
            mx16 = _resample_matrices(scale[lo:hi], shift_x[lo:hi], out_w, w)
            my16 = _resample_matrices(scale[lo:hi], shift_y[lo:hi], out_h, h)
        mx32 = _resample_matrices(
            scale[lo:hi], shift_x[lo:hi], out_w, w, dtype=jnp.float32,
            clamp_lo=1.5, clamp_hi=w - 2.5,
        )
        my32 = _resample_matrices(
            scale[lo:hi], shift_y[lo:hi], out_h, h, dtype=jnp.float32,
            clamp_lo=1.5, clamp_hi=h - 2.5,
        )
        vis_x = _axis_visibility(scale[lo:hi], shift_x[lo:hi], out_w, w, feathering)
        vis_y = _axis_visibility(scale[lo:hi], shift_y[lo:hi], out_h, h, feathering)

        if not exact_color:
            # color row pass: (kb, W', W) @ (W, H*4) -> (kb, W', H*4)
            row = jax.lax.dot_general(
                mx16,
                tex_whc,
                dimension_numbers=(((2,), (0,)), ((), ())),
                preferred_element_type=jnp.bfloat16,
            )
            row = row.reshape(kb, out_w, h, 4).transpose(0, 2, 1, 3).reshape(kb, h, out_w * 4)
            col = jax.lax.dot_general(
                my16,
                row,
                dimension_numbers=(((2,), (1,)), ((0,), (0,))),
                preferred_element_type=jnp.float32,
            )  # (kb, H', W'*4)
            warped = col.reshape(kb, out_h, out_w, 4)

        # disp passes in f32 (precision=HIGHEST keeps full f32 mantissas)
        drow = jax.lax.dot_general(
            mx32,
            disp_wh,
            dimension_numbers=(((2,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )  # (kb, W', H)
        dcol = jax.lax.dot_general(
            my32,
            drow.transpose(0, 2, 1),
            dimension_numbers=(((2,), (1,)), ((0,), (0,))),
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )  # (kb, H', W')
        d_k = izmax + (izmin - izmax) * dcol
        # occupancy CONSUMES the ray (even beyond the border, like the
        # march crossing the edge-clamped surface); visibility — inside x
        # taper x mask — scales the contribution only (see ops/sweep.py)
        if exact_color:
            # FIRST-CROSSING depth solve (the march's semantics): the
            # surface is where diff = d(invZ) - invZ changes sign marching
            # near -> far; interpolate the crossing between the bracketing
            # planes (the march's step-halving converges to the same root).
            for k in range(kb):
                diff = d_k[k] - invz[lo + k]
                crossed = jnp.logical_and(~found, diff > 0.0)
                if lo + k == 0:
                    # first plane: no bracket yet (prev_invz is a zero
                    # placeholder) — snap the crossing to the plane itself
                    # (t=1), not to invz=0
                    t = jnp.ones_like(diff)
                else:
                    t = prev_diff / jnp.minimum(prev_diff - diff, -1e-12)
                    t = jnp.clip(t, 0.0, 1.0)
                cand = prev_invz + t * (invz[lo + k] - prev_invz)
                invz_star = jnp.where(crossed, cand, invz_star)
                found = jnp.logical_or(found, crossed)
                prev_diff = diff
                prev_invz = jnp.full_like(diff, invz[lo + k])
        else:
            occ = jax.nn.sigmoid(
                (d_k - invz[lo:hi, None, None]) * sharp[lo:hi, None, None]
            )
            vis = (
                vis_y[:, :, None]
                * vis_x[:, None, :]
                * jnp.clip(warped[..., 3], 0.0, 1.0)
            )
            # stream the front-to-back composite through the chunk
            for k in range(kb):
                w_k = transmittance * occ[k]
                acc_rgb = acc_rgb + (w_k * vis[k])[..., None] * warped[k, ..., 0:3]
                acc_a = acc_a + w_k * vis[k]
                transmittance = transmittance * (1.0 - occ[k])

    if exact_color:
        # ONE bilinear gather of [rgb, mask] at the solved parallax
        # position — march-like color accuracy at the cost of a single
        # gather pass. RGB+mask are packed into one int32 channel so the
        # gather is 4 taps, not 16.
        from .sampling import bilinear_sample_packed, pack_rgbm

        invz_hat = invz_star
        b_hat = 1.0 + c1[2] * invz_hat
        scale_hat = b_hat * (f1 / f2)
        jx = jnp.arange(out_w, dtype=jnp.float32)[None, :]
        iy = jnp.arange(out_h, dtype=jnp.float32)[:, None]
        gx = scale_hat * (jx - (out_w - 1) / 2.0) + (w - 1) / 2.0 - f1 * c1[0] * invz_hat
        gy = scale_hat * (iy - (out_h - 1) / 2.0) + (h - 1) / 2.0 - f1 * c1[1] * invz_hat
        u1 = (gx + 0.5) / w
        v1 = (gy + 0.5) / h
        sampled = bilinear_sample_packed(pack_rgbm(rgb, mask), u1, v1, w, h)
        inside = ((u1 > 0.0) & (u1 < 1.0) & (v1 > 0.0) & (v1 < 1.0)).astype(
            jnp.float32
        )
        f = jnp.maximum(feathering, 1e-6)
        tap = (
            _smoothstep(0.0, f, u1) * (1.0 - _smoothstep(1.0 - f, 1.0, u1))
            * _smoothstep(0.0, f, v1) * (1.0 - _smoothstep(1.0 - f, 1.0, v1))
        )
        alpha = (
            found.astype(jnp.float32)
            * inside
            * tap
            * jnp.clip(sampled[..., 3], 0.0, 1.0)
        )
        acc_rgb = sampled[..., :3] * alpha[..., None]
        acc_a = alpha

    out_rgb = background[:3] * background[3] * (1.0 - acc_a[..., None]) + acc_rgb
    out_a = background[3] + acc_a * (1.0 - background[3])
    if to_srgb:
        out_rgb = linear_to_srgb(out_rgb)
    return jnp.concatenate([out_rgb, out_a[..., None]], axis=-1)


@functools.partial(
    jax.jit,
    static_argnames=("out_w", "out_h", "num_planes", "chunk"),
)
def solve_depth_aligned(
    disp,
    invz_min,
    invz_max,
    c1,
    f2,
    out_w: int,
    out_h: int,
    focal1=None,
    num_planes: int = 40,
    chunk: int = 8,
    plane_invz=None,
):
    """Solve the per-pixel surface inverse depth (source-frame units) for an
    ALIGNED view, gather-free: batched-matmul plane warps of the disparity
    texture + first-crossing interpolation. Returns (out_h, out_w) invZ*
    with 0 where the ray found no surface.

    The returned quantity is the source projector's inverse depth of the
    hit, which is independent of the render camera's ORIENTATION — the
    basis of the rotated fast path (render_rotated)."""
    h, w = disp.shape
    izmin = jnp.asarray(invz_min, jnp.float32)
    izmax = jnp.asarray(invz_max, jnp.float32)
    c1 = jnp.asarray(c1, jnp.float32)
    f1 = jnp.asarray(f2 if focal1 is None else focal1, jnp.float32)
    f2 = jnp.asarray(f2, jnp.float32)

    if plane_invz is None:
        ks = (jnp.arange(num_planes, dtype=jnp.float32) + 0.5) / num_planes
        invz = izmin + (izmax - izmin) * ks
    else:
        invz = jnp.asarray(plane_invz, jnp.float32)
    b = 1.0 + c1[2] * invz
    scale = b * (f1 / f2)
    shift_x = -f1 * c1[0] * invz
    shift_y = -f1 * c1[1] * invz

    disp_wh = disp.astype(jnp.float32).T  # (W, H)
    found = jnp.zeros((out_h, out_w), bool)
    invz_star = jnp.zeros((out_h, out_w), jnp.float32)
    prev_diff = jnp.zeros((out_h, out_w), jnp.float32)
    prev_invz = jnp.zeros((out_h, out_w), jnp.float32)

    n_chunks = (num_planes + chunk - 1) // chunk
    for ci in range(n_chunks):
        lo = ci * chunk
        hi = min(lo + chunk, num_planes)
        kb = hi - lo
        mx32 = _resample_matrices(
            scale[lo:hi], shift_x[lo:hi], out_w, w, dtype=jnp.float32,
            clamp_lo=1.5, clamp_hi=w - 2.5,
        )
        my32 = _resample_matrices(
            scale[lo:hi], shift_y[lo:hi], out_h, h, dtype=jnp.float32,
            clamp_lo=1.5, clamp_hi=h - 2.5,
        )
        drow = jax.lax.dot_general(
            mx32, disp_wh,
            dimension_numbers=(((2,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
        dcol = jax.lax.dot_general(
            my32, drow.transpose(0, 2, 1),
            dimension_numbers=(((2,), (1,)), ((0,), (0,))),
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
        d_k = izmax + (izmin - izmax) * dcol
        for k in range(kb):
            diff = d_k[k] - invz[lo + k]
            crossed = jnp.logical_and(~found, diff > 0.0)
            if lo + k == 0:
                # first plane: no bracket yet (prev_invz is a zero
                # placeholder) — snap the crossing to the plane itself
                # (t=1), not to invz=0
                t = jnp.ones_like(diff)
            else:
                t = prev_diff / jnp.minimum(prev_diff - diff, -1e-12)
                t = jnp.clip(t, 0.0, 1.0)
            cand = prev_invz + t * (invz[lo + k] - prev_invz)
            invz_star = jnp.where(crossed, cand, invz_star)
            found = jnp.logical_or(found, crossed)
            prev_diff = diff
            prev_invz = jnp.full_like(diff, invz[lo + k])

    return jnp.where(found, invz_star, 0.0)


def _projective_blocks(p):
    """Split a (3,3) projective matrix into the s-coordinate blocks used by
    the shader parameterization (see ops/raycast.py)."""
    return (
        p[0, 0], p[0, 1], p[0, 2],
        p[1, 0], p[1, 1], p[1, 2],
        p[2, 0], p[2, 1], p[2, 2],
    )


@functools.partial(
    jax.jit,
    static_argnames=("out_w", "out_h", "num_planes", "chunk", "to_srgb",
                     "fov_margin"),
)
def render_rotated(
    rgb,
    disp,
    mask,
    invz_min,
    invz_max,
    c1,
    rot1,
    f2,
    background,
    out_w: int,
    out_h: int,
    focal1=None,
    num_planes: int = 40,
    chunk: int = 8,
    feathering: float = 0.1,
    to_srgb: bool = True,
    plane_invz=None,
    fov_margin: float = 1.35,
):
    """Fast render for ROTATED novel views (two-phase, two gathers).

    A camera rotation about its own center does not change which surface
    point each ray hits — only the image-plane parameterization. So:

      Phase A (gather-free): solve the surface inverse depth with an
        ALIGNED sweep in an intermediate frame sharing the target camera's
        POSITION but the projector's ORIENTATION, at a widened FOV
        (fov_margin) so it covers all target rays.
      Phase B (elementwise + 2 gathers): for every target pixel, map its
        ray into the intermediate image (pure rotation homography), fetch
        invZ* (one bilinear f32 gather), compute the exact source texture
        coordinate from the full projective raycast geometry, and fetch the
        color (one packed bilinear gather).

    Args mirror render_sweep_aligned plus ``rot1``: the (3, 3) camera-local
    projector rotation (R_cam^T R_proj, scene convention).
    """
    from ..core.transforms import inv3 as _inv3, mat_from_focal as _mff, mm as _mm, shader_rotation as _sr
    from .sampling import bilinear_sample, bilinear_sample_packed, pack_rgbm

    h, w = disp.shape
    izmin = jnp.asarray(invz_min, jnp.float32)
    izmax = jnp.asarray(invz_max, jnp.float32)
    c1 = jnp.asarray(c1, jnp.float32)
    rot1 = jnp.asarray(rot1, jnp.float32)
    f1 = jnp.asarray(f2 if focal1 is None else focal1, jnp.float32)
    f2 = jnp.asarray(f2, jnp.float32)
    background = jnp.asarray(background, jnp.float32)

    # ---- Phase A: aligned depth solve in the intermediate frame ----
    # intermediate camera: target position, projector orientation. Its
    # camera-local projector position is rot1 applied back to c1: with the
    # intermediate orientation equal to the projector's, the camera-local
    # offset R_I^T (p1 - p2) = rot1^T-composed version of the target's.
    # c1 is the target-frame value (Z-negated); undo the negation, rotate,
    # re-negate.
    flip = jnp.asarray([1.0, 1.0, -1.0], jnp.float32)
    c1_scene = c1 * flip
    c1_aligned = (rot1.T @ c1_scene) * flip
    f_i = f2 / fov_margin  # widened intermediate FOV
    invz_map = solve_depth_aligned(
        disp, izmin, izmax, c1_aligned, f_i,
        out_w=out_w, out_h=out_h, focal1=f1,
        num_planes=num_planes, chunk=chunk, plane_invz=plane_invz,
    )

    # ---- Phase B ----
    # target-frame raycast geometry (full projective, skew-free)
    skr1 = _sr(rot1)  # flipZ rot1^T flipZ
    fskr1 = _mm(_mff(f1 / w, f1 / h), skr1)
    fskr2 = _mff(f2 / out_w, f2 / out_h)
    p_ts = _mm(fskr1, _inv3(fskr2))  # target s2 -> source q
    c_vec = jnp.matmul(fskr1, (-c1)[..., None],
                       precision=jax.lax.Precision.HIGHEST)[..., 0]

    # target s2 -> intermediate s_I (pure rotation homography)
    fskr_i = _mm(_mff(f_i / out_w, f_i / out_h), skr1)
    p_ti = _mm(fskr_i, _inv3(fskr2))

    jx = jnp.arange(out_w, dtype=jnp.float32)[None, :]
    iy = jnp.arange(out_h, dtype=jnp.float32)[:, None]
    s2x = (jx + 0.5) / out_w - 0.5
    s2y = (iy + 0.5) / out_h - 0.5
    s2x, s2y = jnp.broadcast_arrays(s2x, s2y)

    def proj_apply(p, sx, sy):
        a00, a01, a02, a10, a11, a12, a20, a21, a22 = _projective_blocks(p)
        den = a20 * sx + a21 * sy + a22
        return (
            (a00 * sx + a01 * sy + a02) / den,
            (a10 * sx + a11 * sy + a12) / den,
            den,
        )

    six, siy, _ = proj_apply(p_ti, s2x, s2y)
    invz_hat = bilinear_sample(invz_map, six + 0.5, siy + 0.5, out_w, out_h)
    found = invz_hat > 0.0

    qx, qy, den_t = proj_apply(p_ts, s2x, s2y)
    s1x = c_vec[0] * invz_hat + (1.0 - c_vec[2] * invz_hat) * qx
    s1y = c_vec[1] * invz_hat + (1.0 - c_vec[2] * invz_hat) * qy
    u1 = s1x + 0.5
    v1 = s1y + 0.5
    sampled = bilinear_sample_packed(pack_rgbm(rgb, mask), u1, v1, w, h)

    inside = ((u1 > 0.0) & (u1 < 1.0) & (v1 > 0.0) & (v1 < 1.0)).astype(
        jnp.float32
    )
    # intermediate-image coverage: rays outside the widened FOV are unknown
    covered = (
        (jnp.abs(six) < 0.5) & (jnp.abs(siy) < 0.5)
    ).astype(jnp.float32)
    f = jnp.maximum(feathering, 1e-6)
    tap = (
        _smoothstep(0.0, f, u1) * (1.0 - _smoothstep(1.0 - f, 1.0, u1))
        * _smoothstep(0.0, f, v1) * (1.0 - _smoothstep(1.0 - f, 1.0, v1))
    )
    alpha = (
        found.astype(jnp.float32)
        * covered
        * inside
        * tap
        * jnp.clip(sampled[..., 3], 0.0, 1.0)
    )
    acc_rgb = sampled[..., :3] * alpha[..., None]
    out_rgb = background[:3] * background[3] * (1.0 - alpha[..., None]) + acc_rgb
    out_a = background[3] + alpha * (1.0 - background[3])
    if to_srgb:
        out_rgb = linear_to_srgb(out_rgb)
    return jnp.concatenate([out_rgb, out_a[..., None]], axis=-1)
