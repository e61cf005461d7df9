"""Two-phase march for ROTATED (and zoomed) novel views — the
rotated fallback tier, replacing the K=40 matmul sweep of
ops/sweep_fast.render_rotated as the quality/speed bottleneck.

A camera rotation about its own center never changes which surface each
ray hits — only the image-plane parameterization
(reference: src/shaders/rayCastMonoLDI.glsl:219-297 runs the same march
for any FSKR2). So:

  Phase A: solve the surface inverse depth with
    the SCALED first-crossing march (ops/sweep_scaled) in an
    intermediate frame sharing the target camera's POSITION but the
    projector's ORIENTATION and FOCAL — the aligned frame where every
    plane's warp is separable-affine. Matched focal means the
    intermediate image keeps the source's angular resolution: its
    extent (wi, hi) covers the target frustum's corner rays plus a
    guard, so no target ray is unsolved. depth_only: no color pass.

  Phase B (elementwise + ~12 flat gathers): per target pixel, map its
    ray into the intermediate image (pure rotation homography), fetch
    the 2x2 corner invZ patch (one 4-wide patch-row gather), BRACKET
    the crossing with the corner min/max, then run the reference march
    recurrence over only that bracket against the ORIGINAL source
    disparity (_bracket_march: ~10 bilinear disp reads, fused
    step-back/halving exactly like rayCastMonoLDI.glsl:253-274) — the
    march-exact replacement for an edge-aware depth
    interpolation, whose intermediate-lattice bound capped this tier at
    ~34-38 dB. Finally compute the exact projective source coordinate
    at the solved invZ and fetch the color (one packed patch-row
    gather).

The pure-rotation / pure-zoom special case (|c1| ~ 0) needs no Phase A
at all: with no parallax the intermediate image IS the source view, so
the decoded disparity map serves as invZ* directly (exact).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from . import composite as _composite
from ..core.transforms import (
    inv3,
    mat_from_focal,
    mat_from_skew,
    mm,
    shader_rotation,
)
from .sampling import (
    _patch_table,
    bilinear_sample_packed,
    pack_rgbm,
    read_disp,
)
from .sweep_scaled import ScaledPlan, render_scaled_batch

__all__ = [
    "intermediate_extent",
    "render_rotated_march_batch",
]


def intermediate_extent(rot_list, f1, f2, out_w, out_h, guard_px=16.0,
                        bucket=64, sk1=(0.0, 0.0), sk2=(0.0, 0.0)):
    """Host math: intermediate image half-extents covering every target
    corner ray across the pose batch, at the SOURCE focal f1.

    For each rotation R (camera-local projector rotation) the target
    corner rays d2 = (±out_w/(2 f2) + sk2.x, ±out_h/(2 f2) + sk2.y, 1)
    (a skewed target frustum shifts every ray direction by sk2,
    rayCastMonoLDI.glsl:83-88) land in the aligned frame at R^T-rotated
    directions; their image coordinates at focal f1 bound the extent,
    plus the intermediate frustum's own sk1 shift. Returns (wi, hi)
    bucketed for compile reuse (wi to 128 so the band grid gets wide
    tiles)."""
    import numpy as np

    half_w = out_w / (2.0 * float(f2))
    half_h = out_h / (2.0 * float(f2))
    corners = np.array(
        [[sx * half_w + sk2[0], sy * half_h + sk2[1], 1.0]
         for sx in (-1, 1) for sy in (-1, 1)]
    )
    max_x = max_y = 0.0
    for rot in rot_list:
        r = np.asarray(rot, np.float64)
        # scene convention: d_aligned = R^T d2 (camera-local projector
        # rotation maps projector axes into the camera frame); the
        # shader-space z flip cancels for direction ratios
        d = corners @ r  # rows: R^T @ corner
        z = np.maximum(d[:, 2], 1e-6)
        max_x = max(max_x, float(np.max(np.abs(d[:, 0] / z))))
        max_y = max(max_y, float(np.max(np.abs(d[:, 1] / z))))
    wi = 2.0 * (max_x + abs(sk1[0])) * float(f1) + 2.0 * guard_px
    hi = 2.0 * (max_y + abs(sk1[1])) * float(f1) + 2.0 * guard_px
    wi = max(128, -int(-wi // 128) * 128)
    hi = max(bucket, -int(-hi // bucket) * bucket)
    return wi, hi


def plan_rotated(
    src_w: int,
    src_h: int,
    out_w: int,
    out_h: int,
    f1: float,
    f2: float,
    rot_list,
    c1_list,
    izmin: float,
    izmax: float,
    step_px: float = 1.0,
    guard_px: float = 16.0,
    wi_cap_factor: float = 4.0,
    num_planes: int | None = None,
    sk1=(0.0, 0.0),
    sk2=(0.0, 0.0),
):
    """Host-side setup shared by the renderer and the tests: intermediate
    extent, aligned-frame poses, the scaled plan, and per-pose plane
    grids. Raises ValueError when the pose family exceeds the kernel
    budgets (renderer falls back to the matmul sweep).

    Frustum skew: the intermediate frame keeps the SOURCE skew sk1, so
    phase A stays a pure translation with P = I; the only phase-A effect
    is C = F1 S(sk1) (-c) — folded as the equivalent position adjustment
    c' = c - sk1 * c_z (mat_from_skew rows [1, 0, -sk.x]). Phase B puts
    S(sk1)/S(sk2) in their reference slots (FSKR sandwiches,
    rayCastMonoLDI.glsl:316-332).

    Returns (plan, wi, hi, c1_aligned (B,3) f64, grids (B,K) f32, K,
    skip_phase_a)."""
    import numpy as np

    wi, hi = intermediate_extent(
        rot_list, f1, f2, out_w, out_h, guard_px=guard_px, sk1=sk1,
        sk2=sk2,
    )
    if wi > wi_cap_factor * max(out_w, src_w) or hi > wi_cap_factor * max(
        out_h, src_h
    ):
        raise ValueError(
            f"rotation too large: intermediate extent {wi}x{hi}"
        )
    flip = np.array([1.0, 1.0, -1.0])
    aligned = np.stack(
        [
            flip * (np.asarray(r, np.float64).T @ (flip * np.asarray(c, np.float64)))
            for r, c in zip(rot_list, c1_list)
        ]
    )
    # source-skew fold for the skewed aligned frame (see docstring)
    aligned[:, 0] -= sk1[0] * aligned[:, 2]
    aligned[:, 1] -= sk1[1] * aligned[:, 2]
    skip_phase_a = bool(np.abs(aligned).max() * izmin * f1 < 0.25)
    if skip_phase_a:
        # no parallax: the source itself is the intermediate depth map
        wi, hi = src_w, src_h
        return None, wi, hi, aligned, None, 0, True
    cx_max = float(np.abs(aligned[:, 0]).max())
    cy_max = float(np.abs(aligned[:, 1]).max())
    cz_lo = float(min(aligned[:, 2].min(), 0.0))
    cz_hi = float(max(aligned[:, 2].max(), 0.0))
    from .sweep_scaled import parallax_step_grids_batch, scaled_plan

    plan = scaled_plan(
        src_w, src_h, wi, hi, f1, 1.0, cx_max, cy_max, cz_lo, cz_hi,
        izmin, izmax,
    )
    grids, k = parallax_step_grids_batch(
        f1, aligned, 1.0, wi, hi, izmin, izmax, step_px=step_px,
        num_planes=num_planes,
    )
    return plan, wi, hi, aligned, grids, k, False


def _proj_apply(p, sx, sy):
    den = p[2, 0] * sx + p[2, 1] * sy + p[2, 2]
    return (
        (p[0, 0] * sx + p[0, 1] * sy + p[0, 2]) / den,
        (p[1, 0] * sx + p[1, 1] * sy + p[1, 2]) / den,
    )


def _fetch_invz_edge_aware(izmaps, u, v, wi, hi, jump):
    """Batched edge-aware bilinear fetch of per-pose invz maps.

    izmaps: (B, Hi, Wi) with 0 where no surface; u/v: (B, H, W) in
    [0, 1]. ONE flat 4-wide patch-row gather across the whole batch
    (per-pose tables flattened with a pose offset). Where the 2x2 patch
    spreads more than `jump` (a depth discontinuity or a found/miss
    boundary), the bilinear average would synthesize a mid-air depth —
    snap to the corner with the largest bilinear weight instead."""
    b_n, h_i, w_i = izmaps.shape
    sx = u * wi - 0.5
    sy = v * hi - 0.5
    x0 = jnp.floor(sx).astype(jnp.int32)
    y0 = jnp.floor(sy).astype(jnp.int32)
    fx = sx - jnp.floor(sx)
    fy = sy - jnp.floor(sy)
    fx = jnp.where((x0 >= 0) & (x0 < w_i - 1), fx, 0.0)
    fy = jnp.where((y0 >= 0) & (y0 < h_i - 1), fy, 0.0)
    ix0 = jnp.clip(x0, 0, w_i - 1)
    iy0 = jnp.clip(y0, 0, h_i - 1)
    table = jax.vmap(_patch_table)(izmaps).reshape(b_n * h_i * w_i, 4)
    pose_off = (
        jnp.arange(b_n, dtype=jnp.int32)[:, None, None] * (h_i * w_i)
    )
    flat_idx = (pose_off + iy0 * w_i + ix0).reshape(-1)
    quad = jnp.take(table, flat_idx, axis=0).reshape(u.shape + (4,))
    w00 = (1 - fx) * (1 - fy)
    w01 = fx * (1 - fy)
    w10 = (1 - fx) * fy
    w11 = fx * fy
    wts = jnp.stack([w00, w01, w10, w11], axis=-1)
    bil = jnp.sum(quad * wts, axis=-1)
    spread = jnp.max(quad, axis=-1) - jnp.min(quad, axis=-1)
    nearest = jnp.take_along_axis(
        quad, jnp.argmax(wts, axis=-1)[..., None], axis=-1
    )[..., 0]
    return jnp.where(spread > jump, nearest, bil), quad


def _bracket_march(
    disp,
    qx,
    qy,
    den,
    c_vec,
    quad,
    izmin,
    izmax,
    res_w,
    res_h,
    num_steps: int,
    unroll: bool,
):
    """Per-target-ray first-crossing march over a LATTICE-SEEDED bracket.

    The 2x2 intermediate-lattice corner depths `quad` (0 = that lattice
    ray found no surface) bracket each final ray's crossing; the
    reference march recurrence (rayCastMonoLDI.glsl:253-274 — fixed
    steps, step-back + halve on crossing) then runs over ONLY that
    bracket against the ORIGINAL source disparity, evaluated along the
    exact per-ray affine source path s1(v) = q + v*(c - c_z*q). In
    smooth regions the bracket is a few plane-steps wide, so num_steps
    of fused march+halving land within ~bracket/2^(n-1) of the exact
    crossing of the bilinear disparity field — the same fixed point the
    converged exact kernel solves; at depth edges it reproduces the
    reference's front-to-back semantics instead of interpolating depth
    across the discontinuity (the former ~37 dB intermediate-lattice
    bound of this module).

    Bracket rules: front = max valid corner + margin (clipped to izmin);
    back = min valid corner - margin, extended to izmax when ANY corner
    missed (the surface may genuinely end here — the reference samples
    the far plane on a miss, hit validity being |s1| < 0.5 && invz2 > 0,
    rayCastMonoLDI.glsl:275). All-corners-missed pixels keep the
    degenerate bracket [izmax, izmax]: the march is a no-op and the ray
    samples at izmax exactly like the reference's no-crossing rays.

    Returns (invz_star, invz2, confidence): confidence carries the
    reference's disparity-gradient "stretch mark" kill as the
    step-size-invariant slope rule |d disp / d invz| > 2.8
    (grad_thr/step = 0.02*range*140/steps / (range/steps),
    rayCastMonoLDI.glsl:236,265-267) so stereo occlusion fill can key on
    it exactly as the exact kernel does."""
    valid = quad > 0.0
    nvalid = jnp.sum(valid.astype(jnp.int32), axis=-1)
    big = jnp.float32(1e9)
    v_front = jnp.max(jnp.where(valid, quad, -big), axis=-1)
    v_back = jnp.min(jnp.where(valid, quad, big), axis=-1)
    spread = jnp.where(nvalid > 0, v_front - v_back, 0.0)
    margin = 0.02 * (izmin - izmax) + 0.25 * spread
    v_start = jnp.minimum(izmin, v_front + margin)
    v_end = jnp.maximum(izmax, v_back - margin)
    v_end = jnp.where(nvalid < 4, izmax, v_end)
    # all-miss: degenerate bracket at the far plane (reference miss
    # semantics — sample at izmax, validity decides alpha)
    v_start = jnp.where(nvalid == 0, izmax, v_start)
    v_end = jnp.where(nvalid == 0, izmax, v_end)

    dsx = c_vec[:, 0, None, None] - c_vec[:, 2, None, None] * qx
    dsy = c_vec[:, 1, None, None] - c_vec[:, 2, None, None] * qy
    c_z = c_vec[:, 2, None, None]

    dinvz0 = (v_start - v_end) / float(num_steps)
    invz = v_start + dinvz0  # step back once before the loop, like the
    # reference (:251): the first iteration lands exactly on v_start
    dinvz = dinvz0
    old_disp = jnp.zeros_like(invz)
    invz2 = jnp.zeros_like(invz)
    confidence = jnp.ones_like(invz)

    def body(carry):
        invz, dinvz, old_disp, invz2, confidence = carry
        invz = invz - dinvz
        disp_v = read_disp(
            disp, qx + invz * dsx + 0.5, qy + invz * dsy + 0.5,
            izmin, izmax, res_w, res_h,
        )
        grad = disp_v - old_disp
        old_disp = disp_v
        invz2 = invz * den / (1.0 - c_z * invz)
        below = (disp_v > invz) & (invz2 > 0.0)
        confidence = jnp.where(
            below & (jnp.abs(grad) > 2.8 * jnp.abs(dinvz)),
            0.0, confidence,
        )
        invz = jnp.where(below, invz + dinvz, invz)
        dinvz = jnp.where(below, dinvz * 0.5, dinvz)
        return invz, dinvz, old_disp, invz2, confidence

    carry = (invz, dinvz, old_disp, invz2, confidence)
    if unroll:
        for _ in range(num_steps):
            carry = body(carry)
    else:
        carry = jax.lax.fori_loop(
            0, num_steps, lambda _, c: body(c), carry
        )
    invz, dinvz, old_disp, invz2, confidence = carry
    invz2 = invz * den / (1.0 - c_z * invz)
    return invz, invz2, confidence


@functools.partial(
    jax.jit,
    static_argnames=(
        "plan", "num_planes", "out_w", "out_h", "wi", "hi", "mask_mode",
        "to_srgb", "refine", "raw", "skip_phase_a", "bracket_steps",
        "sk1", "sk2",
    ),
)
def render_rotated_march_batch(
    rgb,
    disp,
    mask,
    invz_min,
    invz_max,
    f1,
    c1_b,  # (B, 3) target-frame projector positions (shader convention)
    rot_b,  # (B, 3, 3) camera-local projector rotations
    c1_aligned_b,  # (B, 3) aligned-frame positions (host-precomputed)
    f2,
    plane_grids,  # (B, K) aligned-frame plane tables
    background,
    plan: ScaledPlan,
    num_planes: int,
    out_w: int,
    out_h: int,
    wi: int,
    hi: int,
    feathering: float = 0.1,
    mask_mode: str = "none",
    to_srgb: bool = True,
    refine: int = 1,
    raw: bool = False,
    skip_phase_a: bool = False,
    jump_frac: float = 0.05,
    bracket_steps: int = 10,
    sk1=(0.0, 0.0),
    sk2=(0.0, 0.0),
):
    """Two-phase rotated/zoom render for a pose batch. Returns
    (B, out_h, out_w, 4) with premultiplied rgb over `background`
    (raw=True: the (rgba, alpha, hit, invz) stereo/fusion inputs).

    skip_phase_a: the |c1| ~ 0 case — the decoded source disparity IS
    the intermediate depth map (plan/wi/hi must then equal the source
    dims and plane_grids is unused).
    """
    h, w = disp.shape
    izmin = jnp.asarray(invz_min, jnp.float32)
    izmax = jnp.asarray(invz_max, jnp.float32)
    f1 = jnp.asarray(f1, jnp.float32)
    f2 = jnp.asarray(f2, jnp.float32)
    c1_b = jnp.asarray(c1_b, jnp.float32)
    rot_b = jnp.asarray(rot_b, jnp.float32)
    background = jnp.asarray(background, jnp.float32)
    b_n = c1_b.shape[0]

    # ---- Phase A ----
    if skip_phase_a:
        izmap = jnp.broadcast_to(
            (disp.astype(jnp.float32) * (izmin - izmax) + izmax)[None],
            (b_n, hi, wi),
        )
    else:
        found, izs = render_scaled_batch(
            rgb, disp, mask, izmin, izmax, c1_aligned_b, f1, 1.0,
            plane_grids, jnp.zeros(4, jnp.float32), plan, num_planes,
            mask_mode="none", refine=refine, depth_only=True,
        )
        izmap = jnp.where(found > 0.5, izs, 0.0)

    # ---- Phase B ----
    jx = jnp.arange(out_w, dtype=jnp.float32)[None, :]
    iy = jnp.arange(out_h, dtype=jnp.float32)[:, None]
    s2x = (jx + 0.5) / out_w - 0.5
    s2y = (iy + 0.5) / out_h - 0.5
    s2x, s2y = jnp.broadcast_arrays(s2x, s2y)

    def pose_maps(c1, rot1):
        skr1 = shader_rotation(rot1)
        if sk1 != (0.0, 0.0):
            skr1 = mm(mat_from_skew(sk1[0], sk1[1]), skr1)
        fskr1 = mm(mat_from_focal(f1 / w, f1 / h), skr1)
        fskr2 = mat_from_focal(f2 / out_w, f2 / out_h)
        if sk2 != (0.0, 0.0):
            fskr2 = mm(fskr2, mat_from_skew(sk2[0], sk2[1]))
        p_ts = mm(fskr1, inv3(fskr2))
        c_vec = jnp.matmul(
            fskr1, (-c1)[..., None],
            precision=jax.lax.Precision.HIGHEST,
        )[..., 0]
        den = p_ts[2, 0] * s2x + p_ts[2, 1] * s2y + p_ts[2, 2]
        fskr_i = mm(mat_from_focal(f1 / wi, f1 / hi), skr1)
        p_ti = mm(fskr_i, inv3(fskr2))
        six, siy = _proj_apply(p_ti, s2x, s2y)
        qx, qy = _proj_apply(p_ts, s2x, s2y)
        return six, siy, qx, qy, den, c_vec

    six, siy, qx, qy, den, c_vec = jax.vmap(pose_maps)(c1_b, rot_b)

    _, quad = _fetch_invz_edge_aware(
        izmap, six + 0.5, siy + 0.5, wi, hi,
        jump_frac * (izmin - izmax),
    )
    covered = (jnp.abs(six) < 0.5) & (jnp.abs(siy) < 0.5)

    # lattice-seeded exact march (see _bracket_march): the corner depths
    # only BRACKET the crossing; the solved invz comes from the
    # reference recurrence against the original source disparity
    invz_hat, invz2_m, conf = _bracket_march(
        disp, qx, qy, den, c_vec, quad, izmin, izmax, w, h,
        bracket_steps, False,
    )
    found_hat = (
        (jnp.sum((quad > 0.0).astype(jnp.int32), axis=-1) > 0)
        & (invz2_m > 0.0)
    )

    s1x = c_vec[:, 0, None, None] * invz_hat + (
        1.0 - c_vec[:, 2, None, None] * invz_hat
    ) * qx
    s1y = c_vec[:, 1, None, None] * invz_hat + (
        1.0 - c_vec[:, 2, None, None] * invz_hat
    ) * qy
    u1 = s1x + 0.5
    v1 = s1y + 0.5
    sampled = bilinear_sample_packed(pack_rgbm(rgb, mask), u1, v1, w, h)

    hit, alpha = _composite.edge_alpha(
        found_hat.astype(jnp.float32) * covered.astype(jnp.float32),
        u1, v1, feathering, sampled[..., 3], mask_mode,
    )
    if raw:
        return sampled, alpha, hit, jnp.where(found_hat, invz_hat, 0.0)
    return _composite.finish_over_background(
        sampled[..., :3] * alpha[..., None], alpha, background, to_srgb
    )
