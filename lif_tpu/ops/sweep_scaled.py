"""First-crossing plane march for SCALED warps.

The generalization of ops/sweep_march.py: for an ALIGNED view
(relative rotation identity) with arbitrary translation (cx, cy, cz) and
focal ratio fr = f1/f2, the source position of output pixel (j, i) at
inverse depth v is separable-affine per axis
(reference semantics: src/shaders/rayCastMonoLDI.glsl:249 — s1 is affine
in invZ for any P, C; the aligned decomposition of ops/sweep_fast.py):

    gx(j) = j + dx(j; v),  dx = tx(v) + ex(v) * (j - cx0)
    gy(i) = i + dy(i; v),  dy = ty(v) + ey(v) * (i - cy0)

    ex(v) = ey(v) = fr * (1 + cz * v) - 1          (per-plane uniform scale)
    tx(v) = bx - f1 * cx * v + dx_user             (per-plane shift)
    ty(v) = by - f1 * cy * v + dy_user

with bx = (src_w - out_w)/2, cx0 = (out_w - 1)/2 (and y analogues): both
the translation AND the scale displacement are affine in v. This module
holds the host-side plan/table math, the XLA
implementation (gather-based; it runs on every backend), and the
finalize stage; it is what upgrades rotated / orbit /
dolly / zoom poses from the ~35 dB matmul sweep to march-class fidelity.

Unlike the lateral translation case there is no snap grid (per-pixel
sampling phases differ under scale), so exactness comes from DENSITY: the
grid places one plane per `step_px` pixels of maximum displacement change
(parallax_step_grid), and the in-bracket `refine` sub-sweep
multiplies the effective density only where crossings happen.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from . import composite as _composite

__all__ = [
    "ScaledPlan",
    "scaled_plan",
    "scaled_tables",
    "parallax_step_grid",
    "parallax_step_grids_batch",
    "render_scaled",
    "render_scaled_batch",
    "render_scaled_fetch_batch",
    "render_scaled_xla",
    "finalize_scaled",
    "hit_and_alpha_scaled",
]

_LC = 128  # y-chunk height of the planner's window budget


def _round_up(n: int, q: int) -> int:
    return -(-n // q) * q


class ScaledPlan(NamedTuple):
    """Static geometry of the scaled march (host ints; jit statics).

    Displacements are CLIPPED to [-pad_lo_x, tab_span_x - pad_lo_x] in x
    and [-my_lo, my_hi] in y (edge-saturate, matching the lateral plan's
    pad-border clip); the pads are edge-replicated so saturated samples
    read border texels, and visibility gates them to ~0 alpha anyway.
    """

    src_w: int
    src_h: int
    out_w: int
    out_h: int
    pad_lo_x: int      # left x pad; x displacement clip low = -pad_lo_x
    tab_span_x: int    # max padded x displacement (clip high + margin)
    tw: int            # x band width of a planner tile
    mx: int            # x candidate count (covers scale spread over a band)
    ky_lo: int         # y window chunks below the output chunk
    ky_hi: int         # y window chunks above (incl. the +1 bilinear tap)
    my_lo: int         # y displacement clip low (>= 0, magnitude)
    my_hi: int         # y displacement clip high
    my: int            # y candidate count (covers scale spread over 128 rows)

    @property
    def twx(self) -> int:
        """Extent of the per-plane x slab of the earlier tiled kernel:
        band + candidates + the 8-aligned base remainder + the bilinear
        tap, rounded up to a power-of-two number of 8-row tiles. Kept
        because it sizes the padded source (padded_w)."""
        need = self.tw + self.mx + 9
        t = 1
        while t * 8 < need:
            t *= 2
        return t * 8

    @property
    def bw(self) -> int:
        """Window width: any in-range 8-aligned base + slab."""
        return _round_up(self.tab_span_x + self.twx + 8, 8)

    @property
    def ylen(self) -> int:
        return (self.ky_lo + 1 + self.ky_hi) * _LC

    @property
    def hp_out(self) -> int:
        return _round_up(self.out_h, _LC)

    @property
    def padded_w(self) -> int:
        # last band starts at out_w - tw; its window must fit
        return _round_up(
            max(self.src_w + self.pad_lo_x, (self.out_w - self.tw) + self.bw),
            8,
        )

    @property
    def padded_h(self) -> int:
        # window reach of the last output chunk — but a source TALLER
        # than that reach (outpainted layers carry big margins) must
        # still fit whole: without the max, _pad_stack's top pad goes
        # negative and jnp.pad raises instead of rendering. The extra
        # rows sit beyond every window's reach (the displacement clip
        # saturates inside the window) and are simply never addressed.
        return max(
            self.hp_out + (self.ky_lo + self.ky_hi) * _LC,
            _round_up(self.ky_lo * _LC + self.src_h, _LC),
        )


def _ex_bounds(fr: float, cz_lo: float, cz_hi: float,
               izmin: float, izmax: float):
    """Range of the per-plane scale-minus-one over v in [izmax, izmin]
    and cz in [cz_lo, cz_hi] (all four corners; e is bilinear in (cz, v))."""
    es = [
        fr * (1.0 + cz * v) - 1.0
        for cz in (cz_lo, cz_hi)
        for v in (izmax, izmin)
    ]
    return min(es), max(es)


def scaled_plan(
    src_w: int,
    src_h: int,
    out_w: int,
    out_h: int,
    f1: float,
    fr: float,
    cx_max: float,
    cy_max: float,
    cz_lo: float,
    cz_hi: float,
    izmin: float,
    izmax: float,
    dx_user: float = 0.0,
    dy_user: float = 0.0,
    mx_cap: int = 8,
    ky_cap: int = 2,
) -> ScaledPlan:
    """Build the static plan from host-known pose bounds.

    Raises ValueError when the pose family exceeds the planner's tile
    budgets (sized for an earlier tiled kernel, kept so routing does not
    change) (scale spread needing > mx_cap candidates even at tw=8, or
    a y displacement beyond ky_cap 128-row chunks) — callers fall back to
    the matmul sweep there.
    """
    if out_w % 8 != 0:
        raise ValueError(f"out_w must be 8-divisible, got {out_w}")
    bx = (src_w - out_w) / 2.0
    by = (src_h - out_h) / 2.0
    cx0 = (out_w - 1) / 2.0
    cy0 = (out_h - 1) / 2.0
    e_lo, e_hi = _ex_bounds(fr, cz_lo, cz_hi, izmin, izmax)
    e_abs = max(abs(e_lo), abs(e_hi))

    # x displacement interval over poses/planes/pixels
    shift_span = f1 * cx_max * izmin  # |translation| bound (v <= izmin)
    scale_span = e_abs * cx0
    d_lo = bx + dx_user - shift_span - scale_span
    d_hi = bx + dx_user + shift_span + scale_span
    # cap at one source+output width: beyond that every sample saturates
    # at the pad border and is alpha-gated (same cap as the lateral plan)
    cap = float(src_w + out_w)
    d_lo = max(d_lo, -cap)
    d_hi = min(d_hi, cap)
    pad_lo_x = max(0, int(math.ceil(-d_lo)) + 1)
    tab_span_x = int(math.ceil(d_hi)) + pad_lo_x + 2

    # tile width: the widest divisor of out_w whose per-band scale spread
    # fits the candidate budget
    tw = None
    for cand in (128, 64, 32, 16, 8):
        if out_w % cand == 0 and int(math.ceil(e_abs * (cand - 1))) + 2 <= mx_cap:
            tw = cand
            break
    if tw is None:
        raise ValueError(
            f"scale spread too large for the candidate budget: |e|max="
            f"{e_abs:.4f} needs >{mx_cap} candidates even at tw=8"
        )
    mx = int(math.ceil(e_abs * (tw - 1))) + 2

    # y displacement interval
    yshift_span = f1 * cy_max * izmin
    yscale_span = e_abs * cy0
    dy_lo = by + dy_user - yshift_span - yscale_span
    dy_hi = by + dy_user + yshift_span + yscale_span
    my_lo = max(0, int(math.ceil(-dy_lo)) + 1)
    my_hi = max(0, int(math.ceil(dy_hi)) + 2)
    my = int(math.ceil(e_abs * (_LC - 1))) + 2
    ky_lo = -(-my_lo // _LC)
    # headroom for the y-stage slab: an 8-aligned base at
    # bym_max plus the round8(lc + my + 16) slab extent must fit
    ky_hi = -(-(my_hi + my + 23) // _LC)
    if ky_lo > ky_cap or ky_hi > ky_cap:
        raise ValueError(
            f"y displacement range [{-my_lo}, {my_hi}] exceeds the "
            f"{ky_cap}-chunk window budget"
        )
    return ScaledPlan(
        src_w, src_h, out_w, out_h, pad_lo_x, tab_span_x, tw, mx,
        ky_lo, ky_hi, my_lo, my_hi, my,
    )


def parallax_step_grid(
    f1: float,
    c1,
    fr: float,
    out_w: int,
    out_h: int,
    izmin: float,
    izmax: float,
    step_px: float = 1.0,
    bucket: int = 64,
    max_planes: int = 1024,
    num_planes: int | None = None,
):
    """Uniform inverse-depth grid stepped so the maximum displacement
    change between adjacent planes is <= step_px pixels (host math).

    d(displacement)/dv is bounded by G = max over pixels of
    |f1*c_xy| + |fr*cz| * (dim-1)/2 per axis; one plane per step_px/G of
    inverse depth makes the warped disparity's per-bracket breakpoint
    count ~1 per pixel (positions are exactly affine in v, the source is
    piecewise-linear under bilinear sampling), which the secant + refine
    resolve. The whole BUCKETED count spreads uniformly over the range —
    extra density is free fidelity at a cost the bucket already fixed,
    unlike the snap grid whose pad planes must stay above izmin to keep
    warps exact. Returns (plane_invz float32 (K,), K).
    """
    cx, cy, cz = (float(c1[0]), float(c1[1]), float(c1[2]))
    gx = abs(f1 * cx) + abs(fr * cz) * (out_w - 1) / 2.0
    gy = abs(f1 * cy) + abs(fr * cz) * (out_h - 1) / 2.0
    g = max(gx, gy, 1e-9)
    r = izmin - izmax
    cap = min(max_planes, num_planes) if num_planes else max_planes
    k_real = min(int(math.ceil(r * g / step_px)) + 2, cap)
    k_tot = num_planes if num_planes else max(bucket, _round_up(k_real, bucket))
    grid = np.linspace(izmin, izmax, k_tot, dtype=np.float64)
    return grid.astype(np.float32), k_tot


def parallax_step_grids_batch(
    f1: float,
    c1s,
    fr: float,
    out_w: int,
    out_h: int,
    izmin: float,
    izmax: float,
    step_px: float = 1.0,
    bucket: int = 64,
    max_planes: int = 1024,
    num_planes: int | None = None,
):
    """Per-pose grids padded to one shared bucketed K: (B, K) f32, K."""
    if num_planes:
        k = num_planes
    else:
        k = max(
            parallax_step_grid(f1, c, fr, out_w, out_h, izmin, izmax,
                               step_px=step_px, bucket=bucket,
                               max_planes=max_planes)[1]
            for c in c1s
        )
    tabs = [
        parallax_step_grid(f1, c, fr, out_w, out_h, izmin, izmax,
                           step_px=step_px, bucket=bucket,
                           max_planes=max_planes, num_planes=k)[0]
        for c in c1s
    ]
    return np.stack(tabs), k


def scaled_tables(plan: ScaledPlan, plane_invz, c1, f1, fr,
                  dx_user=0.0, dy_user=0.0):
    """Per-plane warp tables (traced math; (K,) each or batched via vmap).

    Returns (tx, ex, ty, ey): displacement at the image center and slope
    per pixel, per axis: dx(j) = tx + ex*(j - cx0). NOT clipped — the
    consumers clip per pixel to the plan's pad ranges.
    """
    v = jnp.asarray(plane_invz, jnp.float32)
    f1 = jnp.asarray(f1, jnp.float32)
    fr = jnp.asarray(fr, jnp.float32)
    c1 = jnp.asarray(c1, jnp.float32)
    bx = (plan.src_w - plan.out_w) / 2.0
    by = (plan.src_h - plan.out_h) / 2.0
    e = fr * (1.0 + c1[2] * v) - 1.0
    tx = bx - f1 * c1[0] * v + dx_user
    ty = by - f1 * c1[1] * v + dy_user
    return tx, e, ty, e


def hit_and_alpha_scaled(
    plan: ScaledPlan,
    found,
    invz_star,
    rgba_star,
    c1,
    f1,
    fr,
    feathering: float,
    mask_mode: str,
    dx_user=0.0,
    dy_user=0.0,
    crop_y: int = 0,
):
    """Hit validity + composite alpha at the solved surface (the scaled
    generalization of sweep_march.hit_and_alpha; same mask semantics)."""
    c1 = jnp.asarray(c1, jnp.float32)
    f1 = jnp.asarray(f1, jnp.float32)
    fr = jnp.asarray(fr, jnp.float32)
    jx = jnp.arange(plan.out_w, dtype=jnp.float32)[None, :]
    iy = jnp.arange(plan.out_h, dtype=jnp.float32)[:, None]
    bx = (plan.src_w - plan.out_w) / 2.0
    by = (plan.src_h - plan.out_h) / 2.0
    cx0 = (plan.out_w - 1) / 2.0
    cy0 = (plan.out_h - 1) / 2.0
    e = fr * (1.0 + c1[2] * invz_star) - 1.0
    gx = jx + bx + dx_user - f1 * c1[0] * invz_star + e * (jx - cx0)
    gy = iy + by + dy_user - f1 * c1[1] * invz_star + e * (iy - cy0)
    u1 = (gx + 0.5) / plan.src_w
    v1 = (gy + crop_y + 0.5) / (plan.src_h + 2 * crop_y)
    return _composite.edge_alpha(
        found, u1, v1, feathering, rgba_star[..., 3], mask_mode
    )


def finalize_scaled(
    plan: ScaledPlan,
    found,
    invz_star,
    rgba_star,
    c1,
    f1,
    fr,
    background,
    feathering: float,
    mask_mode: str,
    to_srgb: bool,
    raw: bool = False,
    dx_user=0.0,
    dy_user=0.0,
    crop_y: int = 0,
):
    """Validity, taper, mask, premultiply, background, gamma — the scaled
    twin of sweep_march._finalize (raw=True returns the stereo/fusion
    inputs)."""
    hit, alpha = hit_and_alpha_scaled(
        plan, found, invz_star, rgba_star, c1, f1, fr, feathering,
        mask_mode, dx_user=dx_user, dy_user=dy_user, crop_y=crop_y,
    )
    if raw:
        return rgba_star, alpha, hit, invz_star
    return _composite.finish_over_background(
        rgba_star[..., :3] * alpha[..., None], alpha,
        background, to_srgb,
    )


def _pad_stack(plan: ScaledPlan, rgb, disp, mask):
    """Edge-replicate-padded channel stack (5, Wp, Hp), transposed:
    r, g, b, mask, disp along channels, then x, then y."""
    h, w = disp.shape
    rgbm = jnp.concatenate(
        [rgb.astype(jnp.float32), mask.astype(jnp.float32)[..., None]],
        axis=-1,
    )
    stack = jnp.concatenate(
        [rgbm, disp.astype(jnp.float32)[..., None]], axis=-1
    )  # (H, W, 5)
    src_t = stack.transpose(2, 1, 0)  # (5, W, H)
    pad_y_lo = plan.ky_lo * _LC
    return jnp.pad(
        src_t,
        (
            (0, 0),
            (plan.pad_lo_x, plan.padded_w - w - plan.pad_lo_x),
            (pad_y_lo, plan.padded_h - h - pad_y_lo),
        ),
        mode="edge",
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "plan", "num_planes", "mask_mode", "to_srgb", "refine", "raw",
        "crop_y", "depth_only",
    ),
)
def render_scaled_xla(
    rgb,
    disp,
    mask,
    invz_min,
    invz_max,
    c1,  # (3,) aligned-frame projector position (shader convention)
    f1,
    fr,  # f1 / f2 focal ratio (1.0 for matched intrinsics)
    plane_invz,  # (K,) near -> far
    background,
    plan: ScaledPlan,
    num_planes: int,
    feathering: float = 0.1,
    mask_mode: str = "none",
    to_srgb: bool = True,
    refine: int = 0,
    raw: bool = False,
    dx_user: float = 0.0,
    dy_user: float = 0.0,
    crop_y: int = 0,
    depth_only: bool = False,
):
    """XLA implementation of the scaled march: gather-based warps with
    the plan's grid / clip / first-crossing / secant / refine semantics
    (tests/test_sweep_scaled.py).

    depth_only skips color work and returns (found, invz_star) — the
    two-phase rotated path's Phase A needs only the depth solve.
    """
    izmin = jnp.asarray(invz_min, jnp.float32)
    izmax = jnp.asarray(invz_max, jnp.float32)
    invz = jnp.asarray(plane_invz, jnp.float32)
    tx_t, ex_t, ty_t, ey_t = scaled_tables(
        plan, invz, c1, f1, fr, dx_user=dx_user, dy_user=dy_user
    )
    src_t = _pad_stack(plan, rgb, disp, mask)  # (5, Wp, Hp)
    wp, hp = src_t.shape[1], src_t.shape[2]
    flat = src_t.reshape(5, wp * hp)

    oh, ow = plan.out_h, plan.out_w
    jx = jnp.arange(ow, dtype=jnp.float32)[None, :]
    iy = jnp.arange(oh, dtype=jnp.float32)[:, None]
    cx0 = (ow - 1) / 2.0
    cy0 = (oh - 1) / 2.0
    pad_y_lo = plan.ky_lo * _LC

    def warp_at(tx, ex, ty, ey, lo, hi):
        """Bilinear warp of channels [lo, hi) at the separable-affine
        displacement, with the plan's displacement clips (pad saturate)."""
        dxv = jnp.clip(
            tx + ex * (jx - cx0),
            -float(plan.pad_lo_x),
            float(plan.tab_span_x - plan.pad_lo_x),
        )
        dyv = jnp.clip(
            ty + ey * (iy - cy0), -float(plan.my_lo), float(plan.my_hi)
        )
        gx = jx + dxv + plan.pad_lo_x  # padded source coords
        gy = iy + dyv + pad_y_lo
        x0 = jnp.floor(gx).astype(jnp.int32)
        y0 = jnp.floor(gy).astype(jnp.int32)
        fx = gx - x0
        fy = gy - y0
        x0b, y0b = jnp.broadcast_arrays(x0, y0)
        fxb, fyb = jnp.broadcast_arrays(fx, fy)
        base = (x0b * hp + y0b).reshape(-1)

        def ch(c, dxi, dyi):
            return jnp.take(
                flat[c], base + dxi * hp + dyi
            ).reshape(oh, ow)

        outs = []
        for c in range(lo, hi):
            top = ch(c, 0, 0) * (1 - fxb) + ch(c, 1, 0) * fxb
            bot = ch(c, 0, 1) * (1 - fxb) + ch(c, 1, 1) * fxb
            outs.append(top * (1 - fyb) + bot * fyb)
        return outs

    def body(k, carry):
        found, invz_star, rgba_star, prev_diff, prev_rgba = carry
        d_tex = warp_at(tx_t[k], ex_t[k], ty_t[k], ey_t[k], 4, 5)[0]
        d = d_tex * (izmin - izmax) + izmax
        izk = invz[k]
        km1 = jnp.maximum(k - 1, 0)
        prev_iz = invz[km1]
        diff = d - izk
        crossed = (found < 0.5) & (diff > 0.0)

        if refine == 0:
            t = jnp.clip(
                prev_diff / jnp.minimum(prev_diff - diff, -1e-12), 0.0, 1.0
            )
            s_star = t
        else:
            slo = jnp.zeros((oh, ow), jnp.float32)
            pd2 = prev_diff
            d2 = diff
            sfound = jnp.zeros((oh, ow), bool)
            prev_g = prev_diff
            prev_s = 0.0
            step = 1.0 / (refine + 1)
            for jr in range(1, refine + 1):
                s = jr * step
                g = warp_at(
                    tx_t[km1] + s * (tx_t[k] - tx_t[km1]),
                    ex_t[km1] + s * (ex_t[k] - ex_t[km1]),
                    ty_t[km1] + s * (ty_t[k] - ty_t[km1]),
                    ey_t[km1] + s * (ey_t[k] - ey_t[km1]),
                    4, 5,
                )[0] * (izmin - izmax) + izmax - (
                    prev_iz + s * (izk - prev_iz)
                )
                csub = (~sfound) & (g > 0.0)
                slo = jnp.where(csub, prev_s, slo)
                pd2 = jnp.where(csub, prev_g, pd2)
                d2 = jnp.where(csub, g, d2)
                sfound = sfound | csub
                prev_g = g
                prev_s = s
            slo = jnp.where(sfound, slo, prev_s)
            pd2 = jnp.where(sfound, pd2, prev_g)
            t2 = jnp.clip(pd2 / jnp.minimum(pd2 - d2, -1e-12), 0.0, 1.0)
            s_star = slo + step * t2

        s_star = jnp.where(k == 0, jnp.ones_like(s_star), s_star)
        iz_c = prev_iz + s_star * (izk - prev_iz)
        invz_star = jnp.where(crossed, iz_c, invz_star)
        if not depth_only:
            rgba = jnp.stack(
                warp_at(tx_t[k], ex_t[k], ty_t[k], ey_t[k], 0, 4), axis=-1
            )
            rgba_c = prev_rgba + s_star[..., None] * (rgba - prev_rgba)
            rgba_star = jnp.where(crossed[..., None], rgba_c, rgba_star)
            prev_rgba = rgba
        found = jnp.maximum(found, crossed.astype(jnp.float32))
        return found, invz_star, rgba_star, diff, prev_rgba

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
    if depth_only:
        return found, invz_star
    return finalize_scaled(
        plan, found, invz_star, rgba_star, c1, f1, fr, background,
        feathering, mask_mode, to_srgb, raw=raw,
        dx_user=dx_user, dy_user=dy_user, crop_y=crop_y,
    )


def render_scaled(
    rgb, disp, mask, invz_min, invz_max, c1, f1, fr, plane_invz,
    background, plan: ScaledPlan, num_planes: int, **kw,
):
    """One pose of the scaled march (the XLA implementation)."""
    return render_scaled_xla(
        rgb, disp, mask, invz_min, invz_max, c1, f1, fr, plane_invz,
        background, plan, num_planes, **kw,
    )


def render_scaled_batch(
    rgb, disp, mask, invz_min, invz_max, c1_b, f1, fr, plane_invz,
    background, plan: ScaledPlan, num_planes: int, **kw,
):
    """Pose batch of the scaled march: the vmapped XLA implementation.
    c1_b: (B, 3); plane_invz (K,) shared or (B, K) per-pose. Output
    leading dim B."""
    plane_b = jnp.asarray(plane_invz, jnp.float32)
    if plane_b.ndim == 1:
        plane_b = jnp.broadcast_to(plane_b, (len(c1_b), plane_b.shape[0]))
    return jax.vmap(
        lambda cc, pp: render_scaled_xla(
            rgb, disp, mask, invz_min, invz_max, cc, f1, fr, pp,
            background, plan, num_planes, **kw,
        )
    )(jnp.asarray(c1_b, jnp.float32), plane_b)


@functools.partial(
    jax.jit,
    static_argnames=(
        "plan", "num_planes", "mask_mode", "to_srgb", "refine", "raw",
        "crop_y",
    ),
)
def render_scaled_fetch_batch(
    rgb,
    disp,
    mask,
    invz_min,
    invz_max,
    c1_b,  # (B, 3)
    f1,
    fr,
    plane_invz,
    background,
    plan: ScaledPlan,
    num_planes: int,
    feathering: float = 0.1,
    mask_mode: str = "none",
    to_srgb: bool = True,
    refine: int = 1,
    raw: bool = False,
    dx_user: float = 0.0,
    dy_user: float = 0.0,
    crop_y: int = 0,
):
    """PRODUCTION scaled-tier render: the depth-only march + ONE packed
    bilinear color gather at the solved position.

    The full-color path (render_scaled_batch) lerps the two bracketing
    planes' colours, which is only approximate off a snap grid;
    fetching the colour once at the secant-solved position is an exact
    bilinear sample. Mirrors the two-phase rotated path's Phase B with
    an identity homography and the depth map on its own pixel grid (no
    invz re-fetch). Returns (B, H, W, 4), or raw tuples.
    """
    from .sampling import bilinear_sample_packed, pack_rgbm

    h, w = disp.shape
    c1_b = jnp.asarray(c1_b, jnp.float32)
    f1 = jnp.asarray(f1, jnp.float32)
    fr = jnp.asarray(fr, jnp.float32)
    background = jnp.asarray(background, jnp.float32)
    found, izs = render_scaled_batch(
        rgb, disp, mask, invz_min, invz_max, c1_b, f1, fr, plane_invz,
        jnp.zeros(4, jnp.float32), plan, num_planes, mask_mode="none",
        refine=refine, depth_only=True, dx_user=dx_user, dy_user=dy_user,
    )
    invz_star = jnp.where(found > 0.5, izs, 0.0)

    jx = jnp.arange(plan.out_w, dtype=jnp.float32)[None, :]
    iy = jnp.arange(plan.out_h, dtype=jnp.float32)[:, None]
    bx = (plan.src_w - plan.out_w) / 2.0
    by = (plan.src_h - plan.out_h) / 2.0
    cx0 = (plan.out_w - 1) / 2.0
    cy0 = (plan.out_h - 1) / 2.0
    packed = pack_rgbm(rgb, mask)

    def _one(c1, fnd, izst):
        # sample position at the solved depth (finalize_scaled derives
        # the same gx/gy internally for the taper; the fetch needs them
        # explicitly for the color gather)
        e = fr * (1.0 + c1[2] * izst) - 1.0
        gx = jx + bx + dx_user - f1 * c1[0] * izst + e * (jx - cx0)
        gy = iy + by + dy_user - f1 * c1[1] * izst + e * (iy - cy0)
        u1 = (gx + 0.5) / plan.src_w
        v1 = (gy + crop_y + 0.5) / (plan.src_h + 2 * crop_y)
        sampled = bilinear_sample_packed(packed, u1, v1, w, h)
        return finalize_scaled(
            plan, fnd, izst, sampled, c1, f1, fr, background, feathering,
            mask_mode, to_srgb, raw=raw, dx_user=dx_user, dy_user=dy_user,
            crop_y=crop_y,
        )

    return jax.vmap(_one)(c1_b, found, invz_star)
