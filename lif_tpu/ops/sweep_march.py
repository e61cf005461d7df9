"""Gather-free first-crossing plane march for translated views.

The production fast renderer. For an ALIGNED view (no relative rotation or
skew) with matched focal (f1 == f2) and no camera-axis offset (c1.z == 0),
the source coordinate of the ray through output pixel j at inverse depth
invZ is

    gx(j, invZ) = j + (w1 - out_w)/2 - f1 * c1.x * invZ      (pixels)

— a PURE TRANSLATION of the source image per inverse-depth plane. A
fractional translation is a dynamic slice plus a 2x2 lerp: no gathers,
no matmuls. Sweeping K dense planes near -> far
and detecting the FIRST crossing of the warped disparity over the plane's
inverse depth reproduces the exact ray march's root (the march's fused
step-back-and-halve binary refinement converges to the same first crossing;
reference: src/shaders/rayCastMonoLDI.glsl:253-274). The crossing is
refined by secant interpolation between the bracketing planes, and the
color is the matching lerp of the two planes' warped colors — equivalent to
a bilinear fetch at the refined parallax position once the per-plane
parallax step is sub-pixel (quantile-placed planes concentrate steps where
disparity mass is).

Two implementations share the same plan/tables (backend.march_impl
picks one):
  * render_translation_xla — lax.fori_loop over planes; runs on every
    backend and is the oracle the kernel is tested against.
  * ops/sweep_march_gpu — a Pallas (Triton) kernel for NVIDIA GPUs: one
    program per output tile and pose runs the whole K-plane loop with
    the crossing state in registers.

Border semantics: the march's readDisp clamps sample positions to a 2-texel
interior border (rayCastMonoLDI.glsl:59-61). Here the source is edge-
replicate padded instead, which matches exactly for positions >= 2 texels
outside and differs negligibly inside the 2-texel band (where the
feathering taper is ~0 anyway).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import backend as _backend
from . import composite as _composite

__all__ = [
    "TranslationPlan",
    "translation_plan",
    "plane_tables",
    "render_translation",
    "render_translation_batch",
    "render_translation_xla",
    "prepare_translation_source",
    "snap_plane_table",
    "snap_plane_tables_batch",
]


def snap_plane_table(
    f1: float,
    cx: float,
    izmin: float,
    izmax: float,
    num_planes: int | None = None,
    bucket: int = 64,
    max_planes: int = 1024,
    phase_px: float = 0.0,
    stride: int = 1,
):
    """Integer-parallax plane grid for one lateral pose (host math).

    Planes are placed where the warp shift f1*|cx|*invz is an INTEGER
    number of pixels, plus the range endpoints. At integer shifts the
    bilinear warp degenerates to an exact copy, and a warp at any
    fractional shift t+f IS (1-f)*T_t + f*T_{t+1} of the neighbouring
    integer translates — so between adjacent planes the warped disparity
    is exactly linear in the sweep parameter, the first-crossing secant
    is exact, and the color lerp equals the bilinear fetch at the solved
    position. The sweep on this grid solves the continuous first-crossing
    problem for bilinearly-sampled sources EXACTLY (up to f32): measured
    50.8 dB vs the 640-step converged march on the SFMoMA pose, where
    phase-misaligned uniform grids of the same density measure ~40 dB
    (docs/DESIGN.md 'sampling-phase resonance').

    Returns (plane_invz float32 (K,), K) with K bucketed up to a multiple
    of `bucket`; padding planes are prepended ABOVE izmin (their texel
    thresholds exceed 1, so no pixel ever crosses there). If the integer
    count would exceed max_planes, integers are subsampled at 2-, 4-, ...
    pixel stride
    (still phase-aligned, so warps stay exact; only bracket width grows).
    When num_planes is given it overrides the bucketed size (must be >=
    the snap count after subsampling).
    """
    a = -float(f1) * float(cx)  # total shift(invz) = a*invz + phase_px
    s = abs(a)
    r = izmin - izmax
    cap = min(max_planes, num_planes) if num_planes else max_planes
    if s * r < 1.0 or cap < 4:
        # sub-pixel total parallax: the endpoints alone are exact (the
        # whole range is one linear bracket)
        grid = [izmin, izmax]
    else:
        # planes where the TOTAL shift a*invz + phase_px is an integer:
        # phase_px (the constant skew term applied through the warp
        # tables) phase-shifts the grid so warps stay exact translates
        s_lo, s_hi = sorted((a * izmax + phase_px, a * izmin + phase_px))
        m_lo = math.ceil(s_lo)
        m_hi = math.floor(s_hi)
        # stride > 1: subsample the integer grid (phase-aligned, so warps
        # stay exact translates; only bracket width grows — pair with
        # march_refine to restore interior evaluation points exactly,
        # since sub-planes at j/stride land back on the integer lattice)
        stride = max(1, int(stride))
        while (m_hi - m_lo) // stride + 3 > cap:
            stride *= 2
        vals = (
            np.arange(m_lo, m_hi + 1, stride, dtype=np.float64) - phase_px
        ) / a
        vals = np.sort(vals)[::-1]  # descending invz
        grid = [izmin]
        eps = r * 1e-7
        for v in vals:
            if izmax + eps < v < izmin - eps:
                grid.append(float(v))
        grid.append(izmax)
    k_real = len(grid)
    k_tot = num_planes if num_planes else max(bucket, _round_up(k_real, bucket))
    # pad above izmin, continuing the integer spacing upward (thresholds
    # land > 1: never crossed, skip-table-pruned)
    pad = k_tot - k_real
    step_top = (grid[0] - grid[1]) if len(grid) > 1 else r / 64.0
    top = izmin + step_top * np.arange(pad, 0, -1, dtype=np.float64)
    plane = np.concatenate([top, np.asarray(grid, np.float64)])
    return plane.astype(np.float32), k_tot


def snap_plane_tables_batch(
    f1: float,
    cxs,
    izmin: float,
    izmax: float,
    num_planes: int | None = None,
    bucket: int = 64,
    max_planes: int = 1024,
    phase_px: float = 0.0,
    stride: int = 1,
):
    """Per-pose snap grids padded to one shared bucketed K.
    Returns (plane_invz float32 (B, K), K)."""
    if num_planes:
        k = num_planes
    else:
        k = max(
            snap_plane_table(f1, cx, izmin, izmax, bucket=bucket,
                             max_planes=max_planes, phase_px=phase_px,
                             stride=stride)[1]
            for cx in cxs
        )
    tabs = [
        snap_plane_table(f1, cx, izmin, izmax, num_planes=k, bucket=bucket,
                         max_planes=max_planes, phase_px=phase_px,
                         stride=stride)[0]
        for cx in cxs
    ]
    return np.stack(tabs), k


class TranslationPlan(NamedTuple):
    """Static geometry of the padded source and the sliceable windows.

    All fields are host ints; they parameterize the jitted kernels as
    static arguments. Pads are bucketed to multiples of 64 so smoothly
    varying poses (an orbit trajectory) reuse one compiled kernel.

    tab_span_x/y bound the per-plane integer window starts: ix in
    [0, tab_span_x], iy in [0, tab_span_y]. The pads are sized so that a
    window of (rounded-up) shape fits at any such start: the GPU kernel
    reads (out_w+1 -> x128)-rounded column windows and 8-row tiles.
    """

    src_w: int
    src_h: int
    out_w: int
    out_h: int
    pad_lo_x: int  # left pad of the source, pixels
    pad_hi_x: int
    pad_lo_y: int
    pad_hi_y: int
    tab_span_x: int
    tab_span_y: int

    @property
    def padded_w(self) -> int:
        return self.src_w + self.pad_lo_x + self.pad_hi_x

    @property
    def padded_h(self) -> int:
        return self.src_h + self.pad_lo_y + self.pad_hi_y


def _bucket(n: int, q: int = 64) -> int:
    return int(math.ceil(max(n, 1) / q)) * q


def _round_up(n: int, q: int) -> int:
    return -(-n // q) * q


def translation_plan(
    src_w: int,
    src_h: int,
    out_w: int,
    out_h: int,
    max_shift_x: float,
    max_shift_y: float,
) -> TranslationPlan:
    """Build the static plan from host-known shift bounds.

    max_shift_*: bound on |f1 * c1 * invZ| in pixels over the poses this
    compilation will serve (f1 * |c1| * invz_min). Bucketed so nearby poses
    share a compilation.
    """
    bx = (src_w - out_w) / 2.0
    by = (src_h - out_h) / 2.0
    sx = _bucket(int(math.ceil(abs(max_shift_x))) + 2)
    sy = _bucket(int(math.ceil(abs(max_shift_y))) + 2)
    pad_lo_x = max(0, int(math.ceil(sx - bx)))
    pad_lo_y = max(0, int(math.ceil(sy - by)))
    tab_span_x = int(math.ceil(bx + sx)) + pad_lo_x
    tab_span_y = int(math.ceil(by + sy)) + pad_lo_y
    # widest windows the kernels slice: x -> round_up(out_w+1, 128) lanes,
    # y -> band of round_up(tab_span_y + round_up(th+1, 8), 8) rows starting
    # at out_h - th; +16 rows covers every band size th
    ww = _round_up(out_w + 1, 128)
    pad_hi_x = max(0, tab_span_x + ww - src_w - pad_lo_x)
    pad_hi_y = max(0, out_h + tab_span_y + 16 - src_h - pad_lo_y)
    return TranslationPlan(
        src_w, src_h, out_w, out_h, pad_lo_x, pad_hi_x, pad_lo_y, pad_hi_y,
        tab_span_x, tab_span_y,
    )


def plane_tables(plan: TranslationPlan, plane_invz, c1, f1, dx=0.0):
    """Per-plane slice tables (traced): window starts + bilinear fractions.

    dx: constant extra x-shift in pixels (the frustum-skew fold); snap
    grids built with the matching phase_px keep the TOTAL shift integer.
    Returns (ix, fx, iy, fy) each of shape (K,); ix/iy int32 window starts
    into the padded source, fx/fy float32 fractional offsets.
    """
    invz = jnp.asarray(plane_invz, jnp.float32)
    f1 = jnp.asarray(f1, jnp.float32)
    c1 = jnp.asarray(c1, jnp.float32)
    bx = (plan.src_w - plan.out_w) / 2.0
    by = (plan.src_h - plan.out_h) / 2.0
    tx = bx - f1 * c1[0] * invz + dx + plan.pad_lo_x
    ty = by - f1 * c1[1] * invz + plan.pad_lo_y
    # snap near-integer shifts to EXACT integers: snap grids place planes
    # at integer parallax by construction, but the f32 table arithmetic
    # drifts the product by ~1e-4 px — restoring the intended integer
    # makes the warp an exact copy (fx == 0) and costs at most a 1e-3 px
    # move of a plane that was meant to be integral anyway. The kernel
    # and the XLA twin share these tables.
    tx_r = jnp.round(tx)
    ty_r = jnp.round(ty)
    tx = jnp.where(jnp.abs(tx - tx_r) < 1e-3, tx_r, tx)
    ty = jnp.where(jnp.abs(ty - ty_r) < 1e-3, ty_r, ty)
    # saturate out-of-plan shifts at the pad border (edge-clamp behaviour;
    # visibility is zero out there anyway)
    tx = jnp.clip(tx, 0.0, plan.tab_span_x - 1e-3)
    ty = jnp.clip(ty, 0.0, plan.tab_span_y - 1e-3)
    ix = jnp.floor(tx).astype(jnp.int32)
    iy = jnp.floor(ty).astype(jnp.int32)
    return ix, tx - ix, iy, ty - iy


def pad_sources(plan: TranslationPlan, rgb, disp, mask):
    """Edge-replicate pad; color+mask stacked channel-major (4, Hp, Wp)."""
    pads = (
        (plan.pad_lo_y, plan.pad_hi_y),
        (plan.pad_lo_x, plan.pad_hi_x),
    )
    dpad = jnp.pad(disp.astype(jnp.float32), pads, mode="edge")
    rgbm = jnp.concatenate(
        [rgb.astype(jnp.float32), mask.astype(jnp.float32)[..., None]], axis=-1
    )
    cpad = jnp.pad(rgbm.transpose(2, 0, 1), ((0, 0),) + pads, mode="edge")
    return dpad, cpad


def preshift_source(arr, dx, dy):
    """Constant bilinear shift with edge clamp: out(x, y) = arr(x+dx, y+dy)
    (sampling positions clamped to the array).

    Folds the CONSTANT part of a warp — the frustum-skew term
    -f1*(sk1-sk2), which is invz-independent for unrotated views
    (rayCastMonoLDI.glsl:316-332 with R=I: P = F1*S(sk1-sk2)*F2^-1 is an
    upper-triangular shear, contributing a fixed pixel offset) — into the
    source ONCE, so the per-plane march warps stay pure parallax
    translations. Under snap planes the subsequent warps are integer
    translates of this pre-shifted source, so the fold is exact (one
    bilinear evaluation, the same count the direct skewed march pays).
    arr: (..., H, W) or (H, W, C) handled as trailing spatial dims (H, W)
    when 2-D, else (H, W, C)."""
    a = jnp.asarray(arr, jnp.float32)
    spatial_last = a.ndim == 2
    if not spatial_last and a.ndim != 3:
        raise ValueError(a.shape)
    h, w = a.shape[:2]
    ix = jnp.floor(jnp.asarray(dx, jnp.float32))
    iy = jnp.floor(jnp.asarray(dy, jnp.float32))
    fx = jnp.asarray(dx, jnp.float32) - ix
    fy = jnp.asarray(dy, jnp.float32) - iy
    xs = jnp.clip(
        jnp.arange(w, dtype=jnp.float32) + ix, 0, w - 1
    ).astype(jnp.int32)
    xs1 = jnp.clip(xs + 1, 0, w - 1)
    ys = jnp.clip(
        jnp.arange(h, dtype=jnp.float32) + iy, 0, h - 1
    ).astype(jnp.int32)
    ys1 = jnp.clip(ys + 1, 0, h - 1)

    def gx(m):  # horizontal lerp
        return m[:, xs] * (1.0 - fx) + m[:, xs1] * fx

    def gy(m):  # vertical lerp
        return m[ys] * (1.0 - fy) + m[ys1] * fy

    return gy(gx(a))


def hit_and_alpha(
    plan: TranslationPlan,
    found,
    invz_star,
    rgba_star,
    c1,
    f1,
    feathering: float,
    mask_mode: str,
    offset=(0.0, 0.0),
    crop_y: int = 0,
):
    """Hit validity + composite alpha for the solved surface.

    Mirrors raycast_layer's hit handling (ops/raycast.py:221-276) for the
    aligned case: the final source position follows from invz*. Returns
    (hit, alpha): hit = found x inside (the stereo occlusion-fill tests
    read this, ops/stereo.py), alpha = hit x taper x mask.

    mask_mode: 'multiply' (mono LDI, rayCastMonoLDI.glsl:291), 'none'
    (taper only), or 'hard' — a >= 0.5 threshold on the warped mask
    channel; with a pre-eroded mask (erode_mask_for_stereo) this
    reproduces the stereo shader's dilated isMaskAround discard
    (rayCastStereoLDI.glsl:147-158, 304-305).
    """
    c1 = jnp.asarray(c1, jnp.float32)
    f1 = jnp.asarray(f1, jnp.float32)
    jx = jnp.arange(plan.out_w, dtype=jnp.float32)[None, :]
    iy = jnp.arange(plan.out_h, dtype=jnp.float32)[:, None]
    bx = (plan.src_w - plan.out_w) / 2.0
    by = (plan.src_h - plan.out_h) / 2.0
    # offset: the constant (skew) shift folded into the pre-shifted
    # source; validity must test the TRUE source position
    gx = jx + bx - f1 * c1[0] * invz_star + offset[0]
    gy = iy + by - f1 * c1[1] * invz_star + offset[1]
    # crop_y: the caller center-cropped a TALLER (outpainted) layer to the
    # output height; validity/taper must live in the UNCROPPED layer space
    # so the feather sits at the outpaint edges, not the crop
    u1 = (gx + 0.5) / plan.src_w
    v1 = (gy + crop_y + 0.5) / (plan.src_h + 2 * crop_y)
    return _composite.edge_alpha(
        found, u1, v1, feathering, rgba_star[..., 3], mask_mode
    )


def erode_mask_for_stereo(mask):
    """Precompute the stereo discard mask: min over the 9 bilinear samples
    at +-1.5-texel offsets (isMaskAround, rayCastStereoLDI.glsl:147-158).
    A bilinear sample at +-1.5 texels is the mean of the texels at 1 and 2;
    warping the eroded map and hard-thresholding at 0.5 then reproduces
    the shader's any-sample-below-0.5 discard (exact on binary masks away
    from the 1-texel bleed band). Shifts are EDGE-CLAMPED like the
    shader's texture reads — a wrap-around (jnp.roll) would bleed a
    masked top edge into the bottom rows."""
    m = jnp.asarray(mask, jnp.float32)
    p = jnp.pad(m, 2, mode="edge")
    h, w = m.shape

    def shift(dy, dx):
        return p[2 + dy : 2 + dy + h, 2 + dx : 2 + dx + w]

    def sample(dy, dx):
        # bilinear at offset 1.5*d: mean of the texels at d and 2d
        if dy == 0 and dx == 0:
            return m
        return 0.5 * (shift(dy, dx) + shift(2 * dy, 2 * dx))

    out = m
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            out = jnp.minimum(out, sample(dy, dx))
    return out


def _finalize(
    plan: TranslationPlan,
    found,
    invz_star,
    rgba_star,
    c1,
    f1,
    invz_min,
    background,
    feathering: float,
    mask_mode: str,
    to_srgb: bool,
    raw: bool = False,
    offset=(0.0, 0.0),
    crop_y: int = 0,
):
    """Hit validity, taper, mask, premultiply, background blend.

    raw=True skips the premultiply/background/gamma stages and returns
    (rgba_star, alpha, hit, invz_star) — the stereo blend lattice and the
    multi-projector depth fusion consume these per view before
    compositing (ops/stereo semantics; parallel fusion)."""
    hit, alpha = hit_and_alpha(
        plan, found, invz_star, rgba_star, c1, f1, feathering, mask_mode,
        offset=offset, crop_y=crop_y,
    )
    if raw:
        return rgba_star, alpha, hit, invz_star
    return _composite.finish_over_background(
        rgba_star[..., :3] * alpha[..., None], alpha, background, to_srgb
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "plan", "num_planes", "mask_mode", "to_srgb", "refine", "raw",
        "crop_y",
    ),
)
def render_translation_xla(
    rgb,
    disp,
    mask,
    invz_min,
    invz_max,
    c1,
    f1,
    plane_invz,
    background,
    plan: TranslationPlan,
    num_planes: int,
    feathering: float = 0.1,
    mask_mode: str = "none",
    to_srgb: bool = True,
    refine: int = 0,
    raw: bool = False,
    offset=(0.0, 0.0),
    crop_y: int = 0,
):
    """XLA twin: rolled fori_loop over planes (any backend).

    Args:
      rgb: (H, W, 3) linear source colors, GL-oriented.
      disp: (H, W) normalized inverse depth.
      mask: (H, W) alpha mask.
      invz_min/invz_max: baseline-normalized inverse-depth range (scalars).
      c1: (3,) projector position in the camera frame (shader convention);
        c1[2] must be ~0 (translation case — caller dispatches).
      f1: source focal in pixels; must equal the render focal f2.
      plane_invz: (num_planes,) descending (near -> far) plane positions.
      plan: static TranslationPlan covering the shift range.
      refine: number of interior SUB-PLANE evaluations inside the crossing
        bracket (0 = plain secant between the bracketing planes). With
        refine = n the disparity warp is re-evaluated at s = j/(n+1)
        between the bracketing planes — valid because the per-plane shift
        is affine in invz, so sub-plane shifts are exact interpolations of
        the neighbouring plane shifts — and the secant runs in the 1/(n+1)
        sub-bracket containing the first crossing: n+1 times the effective
        plane density, paid only where crossings happen.
    """
    izmin = jnp.asarray(invz_min, jnp.float32)
    izmax = jnp.asarray(invz_max, jnp.float32)
    invz = jnp.asarray(plane_invz, jnp.float32)
    # offset[0]: the constant skew x-shift rides the warp tables (single
    # bilinear, march-exact); offset[1] is pre-applied by the caller via
    # preshift_source (separable, so also exact) and only affects
    # validity in _finalize
    ix_t, fx_t, iy_t, fy_t = plane_tables(plan, invz, c1, f1, dx=offset[0])
    tx_t = ix_t.astype(jnp.float32) + fx_t
    ty_t = iy_t.astype(jnp.float32) + fy_t
    dpad, cpad = pad_sources(plan, rgb, disp, mask)

    oh, ow = plan.out_h, plan.out_w

    def warp_at(tx, ty, color: bool):
        """Bilinear 2-D translation at fractional offsets (tx, ty)."""
        ix = jnp.floor(tx).astype(jnp.int32)
        iy = jnp.floor(ty).astype(jnp.int32)
        fx = tx - ix
        fy = ty - iy

        def win(arr2d, dy, dx):
            return jax.lax.dynamic_slice(arr2d, (iy + dy, ix + dx), (oh, ow))

        def bil(arr2d):
            top = win(arr2d, 0, 0) * (1.0 - fx) + win(arr2d, 0, 1) * fx
            bot = win(arr2d, 1, 0) * (1.0 - fx) + win(arr2d, 1, 1) * fx
            return top * (1.0 - fy) + bot * fy

        texel = bil(dpad)
        d = texel * (izmin - izmax) + izmax
        rgba = (
            jnp.stack([bil(cpad[c]) for c in range(4)], axis=-1)
            if color
            else None
        )
        return d, rgba

    def body(k, carry):
        found, invz_star, rgba_star, prev_diff, prev_rgba = carry
        d, rgba = warp_at(tx_t[k], ty_t[k], color=True)
        izk = invz[k]
        prev_iz = invz[jnp.maximum(k - 1, 0)]
        diff = d - izk
        crossed = (found < 0.5) & (diff > 0.0)

        if refine == 0:
            t = jnp.clip(
                prev_diff / jnp.minimum(prev_diff - diff, -1e-12), 0.0, 1.0
            )
            # k == 0 snap BEFORE the color lerp (a first-plane crossing
            # has prev_diff == 0 -> t == 0 -> the un-snapped lerp would
            # return the zero-init prev color)
            s_star = jnp.where(k == 0, jnp.ones_like(t), t)
            rgba_c = prev_rgba + s_star[..., None] * (rgba - prev_rgba)
        else:
            # mini-sweep of `refine` interior sub-planes: first sub-bracket
            # with a sign change, then the secant inside it. COLOR is
            # warped at the sub-planes too and lerped within the found
            # SUB-bracket — lerping only the outer planes' colors is a
            # bracket-wide tent blur (the march_stride quality killer:
            # measured 33 dB at stride 2 vs 116 with sub-plane colors on
            # the smooth golden; on snap grids the sub-planes land back
            # on the integer lattice, so sub-plane warps are exact).
            km1 = jnp.maximum(k - 1, 0)
            slo = jnp.zeros((oh, ow), jnp.float32)
            pd2 = prev_diff
            d2 = diff
            c_lo = prev_rgba
            c_hi = rgba
            sfound = jnp.zeros((oh, ow), bool)
            prev_g = prev_diff
            prev_c = prev_rgba
            prev_s = 0.0
            step = 1.0 / (refine + 1)
            for j in range(1, refine + 2):
                s = j * step
                tx_s = tx_t[km1] + s * (tx_t[k] - tx_t[km1])
                ty_s = ty_t[km1] + s * (ty_t[k] - ty_t[km1])
                iz_s = prev_iz + s * (izk - prev_iz)
                if j <= refine:
                    g_s, c_s = warp_at(tx_s, ty_s, color=True)
                    g = g_s - iz_s
                else:
                    g, c_s = diff, rgba  # the k plane itself
                csub = (~sfound) & (g > 0.0)
                slo = jnp.where(csub, prev_s, slo)
                pd2 = jnp.where(csub, prev_g, pd2)
                d2 = jnp.where(csub, g, d2)
                c_lo = jnp.where(csub[..., None], prev_c, c_lo)
                c_hi = jnp.where(csub[..., None], c_s, c_hi)
                sfound = sfound | csub
                prev_g = g
                prev_c = c_s
                prev_s = s
            slo = jnp.where(sfound, slo, prev_s)
            pd2 = jnp.where(sfound, pd2, prev_g)
            t2 = jnp.clip(
                pd2 / jnp.minimum(pd2 - d2, -1e-12), 0.0, 1.0
            )
            s_star = slo + step * t2
            rgba_c = c_lo + t2[..., None] * (c_hi - c_lo)

        s_star = jnp.where(k == 0, jnp.ones_like(s_star), s_star)
        iz_c = prev_iz + s_star * (izk - prev_iz)
        if refine:
            # k == 0 snaps to the first plane (s_star = 1 above); the
            # sub-bracket color lerp must snap with it
            rgba_c = jnp.where(k == 0, rgba, rgba_c)
        invz_star = jnp.where(crossed, iz_c, invz_star)
        rgba_star = jnp.where(crossed[..., None], rgba_c, rgba_star)
        found = jnp.maximum(found, crossed.astype(jnp.float32))
        return found, invz_star, rgba_star, diff, rgba

    init = (
        jnp.zeros((oh, ow), jnp.float32),
        jnp.zeros((oh, ow), jnp.float32),
        jnp.zeros((oh, ow, 4), jnp.float32),
        jnp.zeros((oh, ow), jnp.float32),
        jnp.zeros((oh, ow, 4), jnp.float32),
    )
    found, invz_star, rgba_star, _, _ = jax.lax.fori_loop(
        0, num_planes, body, init
    )
    return _finalize(
        plan, found, invz_star, rgba_star, c1, f1, izmin, background,
        feathering, mask_mode, to_srgb, raw=raw, offset=offset,
        crop_y=crop_y,
    )


def render_translation(
    rgb,
    disp,
    mask,
    invz_min,
    invz_max,
    c1,
    f1,
    plane_invz,
    background,
    plan: TranslationPlan,
    num_planes: int,
    feathering: float = 0.1,
    mask_mode: str = "none",
    to_srgb: bool = True,
    refine: int = 0,
    raw: bool = False,
    offset=(0.0, 0.0),
    crop_y: int = 0,
):
    """One pose: the GPU kernel (a batch of one) where backend.march_impl
    picks it, the XLA twin elsewhere. On the kernel path the pose must be
    lateral (c1 = (cx, 0, 0)), as the renderer routes it."""
    kw = dict(
        feathering=feathering, mask_mode=mask_mode, to_srgb=to_srgb,
        refine=refine, raw=raw, offset=offset, crop_y=crop_y,
    )
    if _backend.march_impl() == "xla":
        return render_translation_xla(
            rgb, disp, mask, invz_min, invz_max, c1, f1, plane_invz,
            background, plan, num_planes, **kw,
        )
    from .sweep_march_gpu import render_translation_batch_gpu

    out = render_translation_batch_gpu(
        rgb, disp, mask, invz_min, invz_max,
        jnp.asarray(c1, jnp.float32)[None], f1, plane_invz, background,
        plan, num_planes, **kw,
    )
    return tuple(o[0] for o in out) if raw else out[0]


def prepare_translation_source(rgb, disp, mask, plan: TranslationPlan):
    """Pose-independent source prep of the march's kernel path (the padded
    stack), or None where the XLA twin runs (it reads the raw textures).
    Traced; pose-chunked callers compute it once per dispatch."""
    if _backend.march_impl() == "xla":
        return None
    from .sweep_march_gpu import prepare_lateral_source

    return prepare_lateral_source(rgb, disp, mask, plan)


def render_translation_batch(
    rgb,
    disp,
    mask,
    invz_min,
    invz_max,
    c1,  # (B, 3) per-pose positions; lateral (x-only) on the kernel path
    f1,
    plane_invz,
    background,
    plan: TranslationPlan,
    num_planes: int,
    feathering: float = 0.1,
    mask_mode: str = "none",
    to_srgb: bool = True,
    refine: int = 0,
    raw: bool = False,
    offset=(0.0, 0.0),
    crop_y: int = 0,
    prepared=None,
):
    """Pose batch: one kernel launch for the whole batch where
    backend.march_impl picks the GPU kernel (poses are its fastest grid
    axis, so the source is read from L2 across them), the vmapped XLA
    twin elsewhere. plane_invz may be (K,) shared or (B, K) per-pose
    (snap grids); `prepared` is prepare_translation_source's output.
    Returns (B, H, W, 4)."""
    kw = dict(
        feathering=feathering, mask_mode=mask_mode, to_srgb=to_srgb,
        refine=refine, raw=raw, offset=offset, crop_y=crop_y,
    )
    if _backend.march_impl() == "xla":
        plane_b = jnp.asarray(plane_invz, jnp.float32)
        if plane_b.ndim == 1:
            plane_b = jnp.broadcast_to(
                plane_b, (len(c1), plane_b.shape[0])
            )
        return jax.vmap(
            lambda cc, pp: render_translation_xla(
                rgb, disp, mask, invz_min, invz_max, cc, f1, pp,
                background, plan, num_planes, **kw,
            )
        )(jnp.asarray(c1, jnp.float32), plane_b)
    from .sweep_march_gpu import render_translation_batch_gpu

    return render_translation_batch_gpu(
        rgb, disp, mask, invz_min, invz_max, c1, f1, plane_invz,
        background, plan, num_planes, prepared=prepared, **kw,
    )
