"""Single-phase TARGET-RAY march for rotated novel views — host math and
the XLA reference implementation.

The replacement for the two-phase rotated path (ops/rotated_march):
instead of solving depth on an intermediate aligned grid and fetching it
back through the rotation homography (whose bilinear fetch quantizes
depth-edge positions to the intermediate lattice — a ~37 dB
ceiling), march the full-resolution source
DIRECTLY along every target ray. The march then has no resampling stage
at all: first-crossing, secant, and color interpolation all happen at
the true target-ray positions, which is march-exact by construction
(reference semantics: src/shaders/rayCastMonoLDI.glsl:219-297 — the
fragment march is per-target-pixel for ANY FSKR2/C; this module is that
march vectorized over planes instead of per-ray loops).

Geometry. With the target-frame relative pose (rot1, c1) and focals
(f1, f2), define (exactly as ops/rotated_march.pose_maps):

    q       = homography(rot1, f1, f2) applied to the target pixel
    c_vec   = FSKR1 @ (-c1)
    s1(v)   = c_vec * v + (1 - c_vec_z * v) * q        (glsl:249)

so the SOURCE PIXEL position of target pixel p at inverse depth v is
affine in v with PER-ELEMENT coefficients:

    X(p, v) = AX(p) + v * DX(p)    AX = (qx + 0.5) * w - 0.5   [index]
    Y(p, v) = AY(p) + v * DY(p)    DX = (c_x - c_z * qx) * w   [px / v]

The tier runs the dense XLA implementation (render_target_xla) on every
backend: a per-plane bilinear gather at the per-element positions. The
plan's window and candidate budgets (plan_from_extents) date from an
earlier tiled kernel; they still decide eligibility, so tier routing is
unchanged.

Eligibility: the x-stage assumes X is independent of the target ROW
(exact for yaw-only relative rotations, h01 == h21 == 0 — the orbit
family); `plan_target` measures the actual row-dependence and raises
when it exceeds a fraction of a pixel. Pitch-dominant rotations go
through the renderer's transpose route or fall back to the two-phase
path.
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
    "TargetPlan",
    "TargetExtents",
    "plan_target",
    "target_extents",
    "bucket_extents",
    "plan_from_extents",
    "target_pose_scalars",
    "target_plane_grids",
    "render_target_batch",
    "render_target_fetch_batch",
    "render_target_xla",
    "finalize_target",
]

# tile geometry of the planner's window budgets (plan_from_extents)
_LC = 128  # y-chunk height
_TW = 8  # band width in target columns
_G = 16  # bands per group: 16 * 8 = 128 output columns


_COARSE_CELL = 8  # skip-span cell width in source px
_TWX_CELLS = 4  # x-stage slab reach in cells


def _round_up(n: int, q: int) -> int:
    return -(-n // q) * q


class TargetPlan(NamedTuple):
    """Static geometry of the target-ray march (host ints; jit statics).

    The XLA march reads only out_w/out_h; the window fields (bw, ylen,
    gspan, the pads) are the eligibility budgets of an earlier tiled
    kernel, kept so that tier routing does not change."""

    src_w: int
    src_h: int
    out_w: int
    out_h: int
    pad_x: int  # symmetric x padding of the source (edge-replicated)
    pad_y: int  # symmetric y padding
    bw: int  # window width, multiple of 8
    ylen: int  # window height, multiple of 128
    nxc: int  # max x hat candidates (static unroll cap, diagonal slide)
    nyc: int  # max y hat candidates
    hp_out: int  # padded output height (lane grid)
    gspan: int  # skip-table sliding span in 8-px source cells
    cm_ylims: tuple  # per-chunk (lo, hi) padded-source row range the
    # skip table must max over — exact bounds of the window table


def _pose_fields_np(rot1, c1, f1, f2, out_w, out_h, src_w, src_h):
    """Float64 host twins of the kernel's pose fields: the full p_ts
    homography matrix and c_vec (matches rotated_march.pose_maps)."""
    skr1 = _shader_rotation_np(np.asarray(rot1, np.float64))
    fskr1 = _mat_from_focal_np(f1 / src_w, f1 / src_h) @ skr1
    fskr2 = _mat_from_focal_np(f2 / out_w, f2 / out_h)
    p_ts = fskr1 @ np.linalg.inv(fskr2)
    c_vec = fskr1 @ (-np.asarray(c1, np.float64))
    return p_ts, c_vec


def _shader_rotation_np(rot):
    """Numpy twin of core.transforms.shader_rotation (z-flip conjugation)."""
    flip = np.diag([1.0, 1.0, -1.0])
    return flip @ np.asarray(rot, np.float64).T @ flip


def _pose_fields_batch_np(rot_b, c1_b, f1, f2, out_w, out_h, src_w, src_h):
    """Vectorized _pose_fields_np over the pose batch: (B, 3, 3) p_ts and
    (B, 3) c_vec without a Python loop (plan_target's per-pose numpy loop
    measured ~1 ms/pose — 120 ms of host time per 120-pose plan call).
    The diagonal focal matrices become row/column scalings; the z-flip
    conjugation is a sign pattern on the transposed rotation. Values are
    fp-equivalent (not bit-identical: inv(diag(f2/w)) vs w/f2 rounds
    once, not twice) — plan_target's ±2 px slack dwarfs the ~1e-13
    relative difference, and the kernel-facing scalars
    (target_pose_scalars) still use the exact per-pose path."""
    rot = np.asarray(rot_b, np.float64)  # (B, 3, 3)
    s = np.array([1.0, 1.0, -1.0])
    skr1 = s[None, :, None] * s[None, None, :] * np.swapaxes(rot, 1, 2)
    row = np.array([f1 / src_w, f1 / src_h, 1.0])
    fskr1 = row[None, :, None] * skr1
    col = np.array([out_w / f2, out_h / f2, 1.0])
    p_ts = fskr1 * col[None, None, :]
    c_vec = np.einsum("bij,bj->bi", fskr1, -np.asarray(c1_b, np.float64))
    return p_ts, c_vec


def _mat_from_focal_np(fx, fy):
    return np.diag([fx, fy, 1.0])


def _proj_np(p, sx, sy):
    den = p[2, 0] * sx + p[2, 1] * sy + p[2, 2]
    return (
        (p[0, 0] * sx + p[0, 1] * sy + p[0, 2]) / den,
        (p[1, 0] * sx + p[1, 1] * sy + p[1, 2]) / den,
    )


def target_pose_scalars(rot1, c1, f1, f2, out_w, out_h, src_w, src_h):
    """(16,) f32 per-pose scalar pack for the kernel: row-major p_ts (9),
    c_vec (3), and 4 spare zeros."""
    p_ts, c_vec = _pose_fields_np(rot1, c1, f1, f2, out_w, out_h,
                                  src_w, src_h)
    out = np.zeros(16, np.float64)
    out[:9] = p_ts.reshape(-1)
    out[9:12] = c_vec
    return out.astype(np.float32)


def target_plane_grids(rot_list, c1_list, f1, f2, out_w, out_h,
                       src_w, src_h, izmin, izmax, step_px=1.0,
                       num_planes=None, bucket=64, max_planes=1024):
    """Per-pose inverse-depth ladders with one shared bucketed K.

    Plane density: at most `step_px` pixels of source-position change per
    plane for ANY target pixel, measured as the L1 path length |DX|+|DY|
    over the four image corners — a diagonal sample path crosses texel
    boundaries on BOTH axes, and each boundary is a kink in the
    piecewise-linear bilinear read that the bracket secant cannot see
    (measured: the per-axis-max bound leaves y-dominant poses at ~34 dB
    on random textures where the L1 bound restores >=40; x-dominant
    orbit poses have |DY| ~ 0 so their ladders are unchanged). Padding
    planes continue ABOVE izmin (texel thresholds > 1: never crossed,
    pruned by the skip test). Returns ((B, K) f32 descending, K)."""
    # vectorized over the pose batch (the per-pose numpy loop measured
    # ~1 ms/pose — interactive novel-pose planning pays this every frame)
    p_ts, c_vec = _pose_fields_batch_np(
        np.stack([np.asarray(r, np.float64) for r in rot_list]),
        np.stack([np.asarray(c, np.float64) for c in c1_list]),
        f1, f2, out_w, out_h, src_w, src_h,
    )
    sx = np.array([-0.5, 0.5, -0.5, 0.5])
    sy = np.array([-0.5, -0.5, 0.5, 0.5])
    den = (p_ts[:, 2, 0, None] * sx + p_ts[:, 2, 1, None] * sy
           + p_ts[:, 2, 2, None])
    qx = (p_ts[:, 0, 0, None] * sx + p_ts[:, 0, 1, None] * sy
          + p_ts[:, 0, 2, None]) / den
    qy = (p_ts[:, 1, 0, None] * sx + p_ts[:, 1, 1, None] * sy
          + p_ts[:, 1, 2, None]) / den
    dx = np.abs(c_vec[:, 0, None] - c_vec[:, 2, None] * qx) * src_w
    dy = np.abs(c_vec[:, 1, None] - c_vec[:, 2, None] * qy) * src_h
    dm = (dx + dy).max(axis=1)  # (B,)
    ks = [
        min(max_planes,
            max(2, int(math.ceil(d * (izmin - izmax) / step_px)) + 2))
        for d in dm
    ]
    k_shared = num_planes or max(bucket, _round_up(max(ks), bucket))
    grids = []
    for k_pose, dmax in zip(ks, dm):
        k_real = min(k_pose, k_shared)
        grid = np.linspace(izmin, izmax, k_real)
        pad = k_shared - k_real
        if pad:
            step = grid[0] - grid[1] if k_real > 1 else (izmin - izmax)
            top = izmin + step * np.arange(pad, 0, -1, dtype=np.float64)
            grid = np.concatenate([top, grid])
        grids.append(grid)
    return np.stack(grids).astype(np.float32), k_shared


class TargetExtents(NamedTuple):
    """Pose-batch-unioned window extents of the target-ray march, in
    UNPADDED source pixel coordinates (int64 host arrays). A plan built
    from any SUPERSET of these extents renders every pose in the batch
    correctly, so extents can be widened (bucket_extents) to make one
    compiled plan serve a pose NEIGHBORHOOD — the interactive-pose
    answer to the reference's per-frame ~0.12 ms pose-update budget
    (ROTATION-MATRIX-API.md:229-241): computing extents for a novel
    pose is vectorized sub-ms numpy, and a bucketed-extent cache hit
    reuses the compiled kernel plus its window tables outright."""

    xlo: np.ndarray  # (ng,) group window x starts (already -2 slack)
    xhi: np.ndarray  # (ng,) exclusive-ish ends (+2 slack)
    ylo: np.ndarray  # (ng, nc)
    yhi: np.ndarray  # (ng, nc)
    nx_need: int
    ny_need: int
    gspan_px: int

    def key(self):
        """Hashable identity for plan caching."""
        return (
            self.xlo.tobytes(), self.xhi.tobytes(),
            self.ylo.tobytes(), self.yhi.tobytes(),
            self.nx_need, self.ny_need, self.gspan_px,
        )


def bucket_extents(ext: TargetExtents, qxy: int = 64,
                   qn: int = 2) -> TargetExtents:
    """Widen extents outward to a coarse lattice: window starts floor to
    qxy, ends ceil to qxy, candidate counts / skip span ceil to qn. Any
    pose whose true extents bucket to the same lattice cell shares the
    plan AND the compiled kernel — correctness by construction, since
    the bucketed extents are a superset of the true ones."""

    def _dn(a):
        return (np.asarray(a, np.int64) // qxy) * qxy

    def _up(a):
        return -(-np.asarray(a, np.int64) // qxy) * qxy

    return TargetExtents(
        xlo=_dn(ext.xlo), xhi=_up(ext.xhi),
        ylo=_dn(ext.ylo), yhi=_up(ext.yhi),
        nx_need=-(-ext.nx_need // qn) * qn,
        ny_need=-(-ext.ny_need // qn) * qn,
        gspan_px=-(-ext.gspan_px // qn) * qn,
    )


def target_extents(
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
    yaw_tol_px: float = 0.35,
) -> TargetExtents:
    """Measure the pose batch's window extents (vectorized host numpy,
    sub-ms per pose). Raises ValueError for non-yaw-family rotations
    (row-dependent x positions beyond `yaw_tol_px`)."""
    gw = _G * _TW
    if out_w % gw:
        raise ValueError(f"out_w {out_w} must be divisible by {gw}")
    nb = out_w // _TW
    ng = out_w // gw
    hp_out = _round_up(out_h, _LC)
    nc = hp_out // _LC
    b_n = len(rot_list)

    ylo_all = np.zeros((b_n, ng, nc), np.int64)
    yhi_all = np.zeros((b_n, ng, nc), np.int64)
    nx_need = 0
    ny_need = 0
    gspan_px = 0

    # batched pose fields: (B, 3, 3) / (B, 3); every per-pose quantity
    # below carries a leading batch axis instead of a Python loop
    p_ts, c_vec = _pose_fields_batch_np(
        np.stack([np.asarray(r, np.float64) for r in rot_list]),
        np.stack([np.asarray(c, np.float64) for c in c1_list]),
        f1, f2, out_w, out_h, src_w, src_h,
    )

    def _proj_b(sx, sy):
        """Batched _proj_np: sx (n,) (or (B, n)), sy scalar -> (B, n)."""
        den = (p_ts[:, 2, 0, None] * sx + p_ts[:, 2, 1, None] * sy
               + p_ts[:, 2, 2, None])
        qx = (p_ts[:, 0, 0, None] * sx + p_ts[:, 0, 1, None] * sy
              + p_ts[:, 0, 2, None]) / den
        qy = (p_ts[:, 1, 0, None] * sx + p_ts[:, 1, 1, None] * sy
              + p_ts[:, 1, 2, None]) / den
        return qx, qy

    # yaw gate: X must not depend on the target row
    jg = (np.arange(nb + 1) * _TW).astype(np.float64)
    sxg = (jg + 0.5) / out_w - 0.5  # band edges (+ right edge)
    qx_m, _ = _proj_b(sxg, 0.0)
    for syg in (-0.5, 0.5):
        qx_t, _ = _proj_b(sxg, syg)
        dxv = np.abs(qx_t - qx_m) * src_w
        dvx = np.abs(c_vec[:, 2, None] * (qx_t - qx_m)) * src_w * izmin
        if (dxv + dvx).max() > yaw_tol_px:
            raise ValueError(
                "rotation has row-dependent x positions "
                f"(max {float((dxv + dvx).max()):.2f} px > "
                f"{yaw_tol_px}); not a yaw-family pose"
            )
    # band-edge positions: X(j, v) = AX + v DX, monotone in j; v in
    # {izmax, izmin} covers the v range (affine in v)
    ax_e = (qx_m + 0.5) * src_w - 0.5  # (B, nb + 1)
    dx_e = (c_vec[:, 0, None] - c_vec[:, 2, None] * qx_m) * src_w
    # per-band x candidate need, DIAGONAL: candidates ride the
    # target column (slab[o + j], the scaled kernel's slide), so the
    # span is the deviation of (pos(j) - j) across a band — the
    # band's footprint only enters through |scale - 1|
    for v in (izmax, izmin):
        diag = ax_e + v * dx_e - jg[None]
        span_b = np.abs(diag[:, 1:] - diag[:, :-1])
        nx_need = max(nx_need, int(np.ceil(span_b.max())) + 3)
    # group x extents and skip-table span (group edges: X monotone)
    ge = np.arange(0, nb + 1, _G)  # group edge indices into ax_e
    gl_b = np.full((b_n, ng), np.inf)
    gh_b = np.full((b_n, ng), -np.inf)
    for v in (izmax, izmin):
        pos = ax_e + v * dx_e
        gl = np.minimum(pos[:, ge[:-1]], pos[:, ge[1:]])
        gh = np.maximum(pos[:, ge[:-1]], pos[:, ge[1:]])
        gl_b = np.minimum(gl_b, gl)
        gh_b = np.maximum(gh_b, gh)
        gspan_px = max(gspan_px, int(np.ceil((gh - gl).max())))
    xlo_all = np.floor(gl_b).astype(np.int64) - 2
    xhi_all = np.ceil(gh_b).astype(np.int64) + 2
    # per (group, chunk) y extents from the 4 tile corners (AY - i
    # and DY are each corner-extremal in (x, y) — qy is a Möbius map
    # in each variable; the kernel bounds the per-plane span by the
    # sum of corner bounds (rlo = r_min + v*d_min), so the plan
    # budgets exactly that decomposition)
    ig = np.minimum(np.arange(nc + 1) * _LC, out_h).astype(np.float64)
    gx_l = sxg[ge[:-1]]
    gx_r = sxg[ge[1:]]
    for ci in range(nc):
        rows = np.array([ig[ci], max(ig[ci], min(ig[ci + 1], out_h)
                                     - 1.0)])
        sy_c = (rows + 0.5) / out_h - 0.5
        a_lo = np.full((b_n, ng), np.inf)
        a_hi = np.full((b_n, ng), -np.inf)
        d_lo = np.full((b_n, ng), np.inf)
        d_hi = np.full((b_n, ng), -np.inf)
        abs_lo = np.full((b_n, ng), np.inf)
        abs_hi = np.full((b_n, ng), -np.inf)
        for sxe in (gx_l, gx_r):
            for rw, sye in zip(rows, sy_c):
                _, qy_c = _proj_b(sxe, sye)  # (B, ng)
                ay_c = (qy_c + 0.5) * src_h - 0.5
                dy_c = (c_vec[:, 1, None] - c_vec[:, 2, None] * qy_c) * src_h
                a_lo = np.minimum(a_lo, ay_c - (rw - ig[ci]))
                a_hi = np.maximum(a_hi, ay_c - (rw - ig[ci]))
                d_lo = np.minimum(d_lo, dy_c)
                d_hi = np.maximum(d_hi, dy_c)
                for v in (izmax, izmin):
                    pos = ay_c + v * dy_c
                    abs_lo = np.minimum(abs_lo, pos)
                    abs_hi = np.maximum(abs_hi, pos)
        ylo_all[:, :, ci] = np.floor(abs_lo).astype(np.int64) - 2
        yhi_all[:, :, ci] = np.ceil(abs_hi).astype(np.int64) + 2
        for v in (izmax, izmin):
            span_v = (a_hi + v * d_hi) - (a_lo + v * d_lo)
            ny_need = max(ny_need, int(np.ceil(span_v.max())) + 3)

    return TargetExtents(
        xlo=xlo_all.min(axis=0), xhi=xhi_all.max(axis=0),
        ylo=ylo_all.min(axis=0), yhi=yhi_all.max(axis=0),
        nx_need=nx_need, ny_need=ny_need, gspan_px=gspan_px,
    )


def plan_from_extents(
    src_w: int,
    src_h: int,
    out_w: int,
    out_h: int,
    ext: TargetExtents,
    nxc_cap: int = 14,
    nyc_cap: int = 80,
    bw_cap: int = 2048,
    channels: int = 1,
):
    """Build the static plan from (possibly widened) extents. Raises
    ValueError when the extents leave the planner's budgets (candidate
    spans beyond the caps, window wider than `bw_cap`, window memory
    budget) — the renderer falls back to the two-phase rotated path.
    These eligibility rules were sized for an earlier tiled kernel and
    are kept so that tier routing does not change."""
    hp_out = _round_up(out_h, _LC)
    nc = hp_out // _LC
    nx_need, ny_need, gspan_px = ext.nx_need, ext.ny_need, ext.gspan_px
    xlo_sh, xhi_sh = ext.xlo, ext.xhi  # (ng,)
    ylo_sh, yhi_sh = ext.ylo, ext.yhi  # (ng, nc)
    if nx_need > nxc_cap:
        raise ValueError(f"x candidate span {nx_need} > cap {nxc_cap}")
    if ny_need > nyc_cap:
        raise ValueError(f"y candidate span {ny_need} > cap {nyc_cap}")

    # bw covers the extent plus the slab reach (o8 never clips: the
    # 8-aligned slab base + _TWX columns always fit)
    bw_need = int((xhi_sh - xlo_sh).max()) + 32 + 16
    bw = _round_up(bw_need, 8)
    if bw > bw_cap:
        raise ValueError(f"window width {bw} > cap {bw_cap}")
    # skip-table sliding span in 8-px cells: a plane's slabs reach at
    # most gspan_px + _TWX + 8 source px from the group's per-plane
    # minimum base cell
    gspan = gspan_px // _COARSE_CELL + _TWX_CELLS + 3
    # DMA lane offsets must be 128-aligned: origins floor to 128, so the
    # window height carries up to 127 rows of slack on top of the span
    ylen_need = int((yhi_sh - ylo_sh).max()) + ny_need + 8 + 128
    ylen = _round_up(max(ylen_need, 2 * _LC), _LC)
    # window budget of the earlier tiled kernel (a 1-channel window for
    # the depth-only production tier); a pose batch whose union window
    # exceeds it falls back to the two-phase tier
    xap = 256 if min(ylen, 384) <= 256 else 512
    window_bytes = (channels * bw * ylen + _G * _TW * (xap + 256)) * 4
    if window_bytes > 13 * 1024 * 1024:
        raise ValueError(
            f"pose-union window needs {window_bytes / 1e6:.1f} MB "
            "(> 13 MiB budget); split the pose batch or fall back"
        )

    # padded-source origins (before alignment). Pads bucket to 64/128 —
    # they are jit STATICS (the padded-source shape), so a drifting
    # interactive camera must not recompile every few pixels of window
    # motion; a bucket step costs only edge-padding memory.
    pad_x = max(0, int(-xlo_sh.min()), int((xlo_sh + bw).max()) - src_w)
    pad_x = _round_up(pad_x, 64)
    xlo_pad = ((xlo_sh + pad_x) // 8) * 8
    # pad_y must be FINAL before computing padded origins (the kernel's
    # yoff uses plan.pad_y); flooring origins to 128 costs <= 127 rows,
    # already budgeted in ylen. pad_y >= ylo_sh.max() + ylen - src_h
    # guarantees window bottoms stay inside the padded image.
    pad_y = _round_up(
        max(0, int(-ylo_sh.min()), int(ylo_sh.max()) + ylen - src_h), 128
    )
    ylo_pad = ((ylo_sh + pad_y) // 128) * 128
    # hp_src in the kernel wrapper is h + 2*pad_y rounded to _LC; ensure
    # every window row exists there
    hp_src = _round_up(src_h + 2 * pad_y, _LC)
    assert int((ylo_pad + ylen).max()) <= hp_src, (ylo_pad.max(), ylen,
                                                  hp_src)

    # cm_ylims is a jit static too: bucket outward to 256-row steps
    # (clamped to the padded source) so window drift rarely re-traces
    hp_src_b = _round_up(src_h + 2 * pad_y, _LC)
    cm_ylims = tuple(
        (
            max(0, (int(ylo_pad[:, c].min()) // 256) * 256),
            min(hp_src_b,
                _round_up(int(ylo_pad[:, c].max()) + ylen, 256)),
        )
        for c in range(nc)
    )
    plan = TargetPlan(
        src_w=src_w, src_h=src_h, out_w=out_w, out_h=out_h,
        pad_x=pad_x, pad_y=pad_y, bw=bw, ylen=ylen,
        nxc=nx_need, nyc=ny_need, hp_out=hp_out, gspan=gspan,
        cm_ylims=cm_ylims,
    )
    assert xlo_pad.min() >= 0 and ylo_pad.min() >= 0
    assert int((xlo_pad + bw).max()) <= src_w + 2 * pad_x + 8
    return plan


def plan_target(
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
    yaw_tol_px: float = 0.35,
    nxc_cap: int = 14,
    nyc_cap: int = 80,
    bw_cap: int = 2048,
    channels: int = 1,
):
    """Exact-extent plan for a pose batch: target_extents +
    plan_from_extents (see those for the contract). The renderer's
    interactive path instead buckets the extents (bucket_extents) so a
    plan serves a pose neighborhood."""
    ext = target_extents(
        src_w, src_h, out_w, out_h, f1, f2, rot_list, c1_list,
        izmin, izmax, yaw_tol_px=yaw_tol_px,
    )
    return plan_from_extents(
        src_w, src_h, out_w, out_h, ext,
        nxc_cap=nxc_cap, nyc_cap=nyc_cap, bw_cap=bw_cap,
        channels=channels,
    )


def render_target_batch(
    rgb,
    disp,
    mask,
    invz_min,
    invz_max,
    pose_b,  # (B, 16) target_pose_scalars rows
    plane_invz,  # (B, K) descending per-pose ladders
    background,
    plan: "TargetPlan",
    num_planes: int,
    feathering: float = 0.1,
    mask_mode: str = "none",
    to_srgb: bool = True,
    raw: bool = False,
):
    """Pose batch of the target-ray march with the bracket colour lerp:
    the vmapped dense XLA implementation. Returns (B, out_h, out_w, 4),
    or per-pose raw tuples."""
    return jax.vmap(
        lambda ps, pv: render_target_xla(
            rgb, disp, mask, invz_min, invz_max, ps, pv, background,
            num_planes, plan.out_w, plan.out_h,
            feathering=feathering, mask_mode=mask_mode,
            to_srgb=to_srgb, raw=raw,
        )
    )(jnp.asarray(pose_b, jnp.float32),
      jnp.asarray(plane_invz, jnp.float32))


@functools.partial(
    jax.jit,
    static_argnames=(
        "plan", "num_planes", "mask_mode", "to_srgb", "raw", "refine",
    ),
)
def render_target_fetch_batch(
    rgb,
    disp,
    mask,
    invz_min,
    invz_max,
    pose_b,  # (B, 16)
    plane_invz,  # (B, K)
    background,
    plan: "TargetPlan",
    num_planes: int,
    feathering: float = 0.1,
    mask_mode: str = "none",
    to_srgb: bool = True,
    raw: bool = False,
    refine: int = 0,
):
    """PRODUCTION target tier: depth-only target-ray march + ONE exact
    packed bilinear color gather at the secant-solved position.

    The bracket color pass (render_target_batch) lerps the two
    bracketing planes' samples,
    which is only approximate off the snap grid (per-pixel sampling
    phases) — measured +7..13 dB from fetching instead (39.3 -> 46.1 dB
    on the y-dominant random-scene golden; same construction as
    ops/sweep_scaled.render_scaled_fetch_batch and the two-phase Phase
    B). Returns (B, out_h, out_w, 4) or
    raw (rgba, alpha, hit, invz) tuples."""
    from .sampling import bilinear_sample_packed, pack_rgbm

    h, w = disp.shape
    izmin = jnp.asarray(invz_min, jnp.float32)
    izmax = jnp.asarray(invz_max, jnp.float32)
    pose_b = jnp.asarray(pose_b, jnp.float32)
    found_b, vstar_b = jax.vmap(
        lambda ps, pv: render_target_xla(
            rgb, disp, mask, invz_min, invz_max, ps, pv, background,
            num_planes, plan.out_w, plan.out_h, depth_only=True,
            refine=refine,
        )
    )(pose_b, jnp.asarray(plane_invz, jnp.float32))

    packed = pack_rgbm(
        jnp.asarray(rgb, jnp.float32), jnp.asarray(mask, jnp.float32)
    )

    def _one(ps, found, vstar):
        ax, dxf, ay, dyf, _, _ = _fields(ps, plan.out_w, plan.out_h, w, h)
        v = jnp.clip(vstar, izmax, izmin)
        u1 = (ax + v * dxf + 0.5) / w
        v1 = (ay + v * dyf + 0.5) / h
        rgba = bilinear_sample_packed(packed, u1, v1, w, h)
        return finalize_target(
            ps, found, vstar, rgba,
            jnp.asarray(background, jnp.float32), izmin, izmax,
            plan.out_w, plan.out_h, w, h, feathering, mask_mode,
            to_srgb, raw,
        )

    return jax.vmap(_one)(pose_b, found_b, vstar_b)


# ---------------------------------------------------------------------------
# the dense, gather-based XLA march (every backend)
# ---------------------------------------------------------------------------


def _fields(pose_sc, out_w, out_h, src_w, src_h, dtype=jnp.float32):
    """Per-pixel AX, DX, AY, DY from the (16,) pose scalar pack."""
    p = pose_sc[:9].reshape(3, 3)
    cv = pose_sc[9:12]
    jx = (jnp.arange(out_w, dtype=dtype) + 0.5) / out_w - 0.5
    iy = (jnp.arange(out_h, dtype=dtype) + 0.5) / out_h - 0.5
    sx, sy = jnp.meshgrid(jx, iy)
    den = p[2, 0] * sx + p[2, 1] * sy + p[2, 2]
    qx = (p[0, 0] * sx + p[0, 1] * sy + p[0, 2]) / den
    qy = (p[1, 0] * sx + p[1, 1] * sy + p[1, 2]) / den
    ax = (qx + 0.5) * src_w - 0.5
    ay = (qy + 0.5) * src_h - 0.5
    dx = (cv[0] - cv[2] * qx) * src_w
    dy = (cv[1] - cv[2] * qy) * src_h
    return ax, dx, ay, dy, qx, qy


def _bil(img, px, py):
    h, w = img.shape[:2]
    x0 = jnp.clip(jnp.floor(px).astype(jnp.int32), 0, w - 2)
    y0 = jnp.clip(jnp.floor(py).astype(jnp.int32), 0, h - 2)
    fx = jnp.clip(px - x0, 0.0, 1.0)
    fy = jnp.clip(py - y0, 0.0, 1.0)
    g = lambda yy, xx: img[yy, xx]
    return (
        g(y0, x0) * (1 - fx) * (1 - fy)
        + g(y0, x0 + 1) * fx * (1 - fy)
        + g(y0 + 1, x0) * (1 - fx) * fy
        + g(y0 + 1, x0 + 1) * fx * fy
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "num_planes", "out_w", "out_h", "mask_mode", "to_srgb", "raw",
        "depth_only", "refine",
    ),
)
def render_target_xla(
    rgb,
    disp,
    mask,
    invz_min,
    invz_max,
    pose_sc,  # (16,) target_pose_scalars
    plane_invz,  # (K,) descending
    background,
    num_planes: int,
    out_w: int,
    out_h: int,
    feathering: float = 0.1,
    mask_mode: str = "none",
    to_srgb: bool = True,
    raw: bool = False,
    depth_only: bool = False,
    refine: int = 0,
):
    """Dense XLA target-ray march (one pose): texel-space pass 1,
    bracket secant, bracket color lerp with k* == 0 snapping to t = 1.

    depth_only=True returns (found (H,W) f32, invz_star (H,W)) with no
    color pass and no finalize — the fetch path's input.

    refine: interior sub-plane evaluations inside the crossing bracket
    (depth only — valid because positions are affine in invz, so
    sub-plane sample positions are exact lerps). Restores the dense
    ladder's depth accuracy when the plane grid is built with a widened
    step_px: (refine + 1) x the effective density, paid only inside
    brackets."""
    h, w = disp.shape
    izmin = jnp.asarray(invz_min, jnp.float32)
    izmax = jnp.asarray(invz_max, jnp.float32)
    dd = disp.astype(jnp.float32)
    ax, dxf, ay, dyf, qx, qy = _fields(pose_sc, out_w, out_h, w, h)
    vg = jnp.asarray(plane_invz, jnp.float32)
    tk = (vg - izmax) / (izmin - izmax)

    def step(carry, kv):
        kstar, pdiffc, diffc, pdiff, k = carry
        v, tkk = kv
        tex = _bil(dd, ax + v * dxf, ay + v * dyf)
        diff = tex - tkk
        crossed = jnp.logical_and(kstar < 0, diff > 0.0)
        kstar = jnp.where(crossed, k, kstar)
        pdiffc = jnp.where(crossed, pdiff, pdiffc)
        diffc = jnp.where(crossed, diff, diffc)
        return (kstar, pdiffc, diffc, diff, k + 1), None

    init = (
        jnp.full((out_h, out_w), -1, jnp.int32),
        jnp.zeros((out_h, out_w), jnp.float32),
        jnp.zeros((out_h, out_w), jnp.float32),
        jnp.zeros((out_h, out_w), jnp.float32),
        jnp.int32(0),
    )
    (kstar, pdiffc, diffc, _, _), _ = jax.lax.scan(
        step, init, (vg, tk)
    )
    t = jnp.clip(
        pdiffc / jnp.minimum(pdiffc - diffc, -1e-12), 0.0, 1.0
    )
    t = jnp.where(kstar == 0, 1.0, t)
    found = kstar >= 0
    km1 = jnp.maximum(kstar - 1, 0)
    kc = jnp.maximum(kstar, 0)
    v0 = vg[km1]
    v1 = vg[kc]
    if refine > 0:
        # sub-bracket first-crossing search at exactly-lerped invz
        # (positions affine in v => sub-plane warps are exact); the
        # secant then runs in the 1/(refine+1) sub-bracket. k* == 0
        # keeps its snap-to-plane rule (s_star = 1).
        t0 = vg[km1]  # invz at bracket lo
        th0 = tk[km1]
        th1 = tk[kc]
        step_s = 1.0 / (refine + 1)
        slo = jnp.zeros((out_h, out_w), jnp.float32)
        pd2 = pdiffc
        d2 = diffc
        sfound = jnp.zeros((out_h, out_w), bool)
        prev_g = pdiffc
        prev_s = 0.0
        for j in range(1, refine + 1):
            s = j * step_s
            vs = t0 + s * (v1 - t0)
            g_ = _bil(dd, ax + vs * dxf, ay + vs * dyf) - (
                th0 + s * (th1 - th0)
            )
            csub = jnp.logical_and(~sfound, g_ > 0.0)
            slo = jnp.where(csub, prev_s, slo)
            pd2 = jnp.where(csub, prev_g, pd2)
            d2 = jnp.where(csub, g_, d2)
            sfound = jnp.logical_or(sfound, csub)
            prev_g = g_
            prev_s = s
        slo = jnp.where(sfound, slo, prev_s)
        pd2 = jnp.where(sfound, pd2, prev_g)
        t2 = jnp.clip(pd2 / jnp.minimum(pd2 - d2, -1e-12), 0.0, 1.0)
        t = slo + step_s * t2
        t = jnp.where(kstar == 0, 1.0, t)
    vstar = v0 + t * (v1 - v0)
    if depth_only:
        return (
            found.astype(jnp.float32),
            jnp.where(found, vstar, 0.0),
        )

    # bracket color lerp at the bracketing planes' positions
    rgbm = jnp.concatenate(
        [rgb.astype(jnp.float32), mask.astype(jnp.float32)[..., None]],
        axis=-1,
    )

    def samp(v):
        px = ax + v * dxf
        py = ay + v * dyf
        return jnp.stack(
            [_bil(rgbm[..., ch], px, py) for ch in range(4)], axis=-1
        )

    c0 = samp(v0)
    c1 = samp(v1)
    rgba = c0 + t[..., None] * (c1 - c0)
    rgba = jnp.where((kstar == 0)[..., None], c1, rgba)
    return finalize_target(
        pose_sc, found.astype(jnp.float32), vstar, rgba,
        jnp.asarray(background, jnp.float32), izmin, izmax,
        out_w, out_h, w, h, feathering, mask_mode, to_srgb, raw,
    )


def finalize_target(
    pose_sc, found, vstar, rgba, background, izmin, izmax,
    out_w, out_h, src_w, src_h, feathering, mask_mode, to_srgb, raw,
):
    """Shared epilogue: visibility taper at the solved position, mask
    gating, background blend, gamma (mirrors rotated_march lines
    296-335; reference: rayCastMonoLDI.glsl taper + main)."""
    ax, dxf, ay, dyf, _, _ = _fields(pose_sc, out_w, out_h, src_w, src_h)
    v = jnp.clip(vstar, izmax, izmin)
    u1 = (ax + v * dxf + 0.5) / src_w
    v1 = (ay + v * dyf + 0.5) / src_h
    hit, alpha = _composite.edge_alpha(
        found, u1, v1, feathering, rgba[..., 3], mask_mode
    )
    if raw:
        return rgba, alpha, hit, jnp.where(found > 0.0, vstar, 0.0)
    return _composite.finish_over_background(
        rgba[..., :3] * alpha[..., None], alpha, background, to_srgb
    )
