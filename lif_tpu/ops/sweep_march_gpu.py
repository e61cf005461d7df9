"""Pallas (Triton) kernel of the lateral snap-plane march, for NVIDIA GPUs.

Same semantics as ops/sweep_march.render_translation_xla, specialized to
the lateral case the renderer routes here: c1 = (cx, 0, 0), matched
focal, source height equal to the output height (taller outpainted
layers are center-cropped by the caller), so every plane's warp is a
pure x translation read from fixed source rows.

The XLA twin is a fori_loop over the K planes whose ~11-float per-pixel
carry goes through device memory on every plane. Here one program owns
one (8 x 128) output tile of one pose and runs the plane loop itself,
the way the reference's fragment shader marches one pixel
(rayCastMonoLDI.glsl:219-297):

  * pass 1 walks the planes near -> far with the crossing state in
    registers. Each plane reads its shift from a (B, K) table and loads
    two coalesced row segments of the disparity channel at x - shift;
    the loop ends once every pixel of the tile has crossed;
  * pass 2 gathers the colour of the two bracketing planes (and, with
    `refine`, the sub-plane samples) at each pixel's own crossing plane.

The padded rgb+mask+disp source (5 x ~1.1 Mpx x 4 B at 1280x800) stays
in L2, so the poses of a batch, which are the fastest grid axis, reuse
it. Results match the twin up to float rounding: the crossing test and
secant are the same arithmetic, evaluated in another order.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from .sweep_march import TranslationPlan, _finalize, pad_sources, plane_tables

__all__ = [
    "TILE_H",
    "TILE_W",
    "prepare_lateral_source",
    "render_translation_batch_gpu",
]

TILE_H, TILE_W = 8, 128  # output tile of one program (powers of two)
_NUM_WARPS = 4


def _round_up(n: int, q: int) -> int:
    return -(-n // q) * q


def prepare_lateral_source(rgb, disp, mask, plan: TranslationPlan):
    """Pose-independent source of the kernel: the edge-padded
    (r, g, b, mask, disp) stack, (5, Hp, Wp). The plan's pads already
    cover every shift the tables can hold plus a tile past the output
    edge (translation_plan rounds the window to 128 columns)."""
    if plan.src_h != plan.out_h:
        raise ValueError(f"center-crop the source to the output first: {plan}")
    dpad, cpad = pad_sources(plan, rgb, disp, mask)
    return jnp.concatenate([cpad, dpad[None]], axis=0)


def _kernel(tx_ref, iy_ref, iz_ref, lim_ref, src_ref, out_ref, *,
            num_planes: int, refine: int):
    p = pl.program_id(0)
    r0 = pl.program_id(1) * TILE_H
    c0 = pl.program_id(2) * TILE_W
    izmin = lim_ref[0]
    izmax = lim_ref[1]
    span = izmin - izmax
    shape = (TILE_H, TILE_W)
    rows = r0 + jax.lax.broadcasted_iota(jnp.int32, shape, 0)
    cols = c0 + jax.lax.broadcasted_iota(jnp.int32, shape, 1)

    def split(tx):
        ix = jnp.floor(tx).astype(jnp.int32)
        return ix, tx - ix.astype(jnp.float32)

    # ---- pass 1: first crossing, disparity only, state in registers
    def cond(carry):
        k, _, _, _, _, n = carry
        return jnp.logical_and(k < num_planes, n < TILE_H * TILE_W)

    def body(carry):
        k, kstar, pdc, dc, pd, n = carry
        ix, fx = split(tx_ref[p, k])
        rs = pl.ds(r0 + iy_ref[p, k], TILE_H)
        a = src_ref[4, rs, pl.ds(c0 + ix, TILE_W)]
        b = src_ref[4, rs, pl.ds(c0 + ix + 1, TILE_W)]
        diff = (a * (1.0 - fx) + b * fx) * span + izmax - iz_ref[p, k]
        crossed = jnp.logical_and(kstar < 0, diff > 0.0)
        kstar = jnp.where(crossed, k, kstar)
        pdc = jnp.where(crossed, pd, pdc)
        dc = jnp.where(crossed, diff, dc)
        n = n + jnp.sum(crossed.astype(jnp.int32))
        return k + 1, kstar, pdc, dc, diff, n

    zeros = jnp.zeros(shape, jnp.float32)
    _, kstar, pdc, dc, _, _ = jax.lax.while_loop(
        cond, body,
        (jnp.int32(0), jnp.full(shape, -1, jnp.int32), zeros, zeros, zeros,
         jnp.int32(0)),
    )

    # ---- pass 2: colour (and sub-plane refine) at each pixel's bracket
    found = kstar >= 0
    kc = jnp.maximum(kstar, 0)
    km1 = jnp.maximum(kstar - 1, 0)
    first = kstar == 0

    def warp(tx, chans):
        """Per-pixel bilinear x-warp at per-pixel shifts tx (a gather)."""
        ix, fx = split(tx)
        rr = rows + iy_ref[p, kc]
        cc = cols + ix
        return [
            src_ref[ch, rr, cc] * (1.0 - fx) + src_ref[ch, rr, cc + 1] * fx
            for ch in chans
        ]

    tx_lo = tx_ref[p, km1]
    tx_hi = tx_ref[p, kc]
    iz_lo = iz_ref[p, km1]
    iz_hi = iz_ref[p, kc]
    c_lo = warp(tx_lo, range(4))
    c_hi = warp(tx_hi, range(4))
    if refine == 0:
        t = jnp.clip(pdc / jnp.minimum(pdc - dc, -1e-12), 0.0, 1.0)
        s_star = jnp.where(first, 1.0, t)
        rgba = [lo + s_star * (hi - lo) for lo, hi in zip(c_lo, c_hi)]
    else:
        # first sub-bracket with a sign change among `refine` interior
        # sub-planes, then the secant inside it (the twin's mini-sweep)
        step = 1.0 / (refine + 1)
        slo = zeros
        pd2, d2 = pdc, dc
        sub_lo, sub_hi = list(c_lo), list(c_hi)
        sfound = jnp.zeros(shape, jnp.bool_)
        prev_g, prev_c, prev_s = pdc, c_lo, 0.0
        for j in range(1, refine + 2):
            s = j * step
            if j <= refine:
                w5 = warp(tx_lo + s * (tx_hi - tx_lo), range(5))
                g = w5[4] * span + izmax - (iz_lo + s * (iz_hi - iz_lo))
                c_s = w5[:4]
            else:
                g, c_s = dc, c_hi
            csub = jnp.logical_and(jnp.logical_not(sfound), g > 0.0)
            slo = jnp.where(csub, prev_s, slo)
            pd2 = jnp.where(csub, prev_g, pd2)
            d2 = jnp.where(csub, g, d2)
            sub_lo = [jnp.where(csub, pc, a) for pc, a in zip(prev_c, sub_lo)]
            sub_hi = [jnp.where(csub, cs, a) for cs, a in zip(c_s, sub_hi)]
            sfound = jnp.logical_or(sfound, csub)
            prev_g, prev_c, prev_s = g, c_s, s
        slo = jnp.where(sfound, slo, prev_s)
        pd2 = jnp.where(sfound, pd2, prev_g)
        t2 = jnp.clip(pd2 / jnp.minimum(pd2 - d2, -1e-12), 0.0, 1.0)
        s_star = jnp.where(first, 1.0, slo + step * t2)
        rgba = [
            jnp.where(first, hi, lo + t2 * (h2 - lo))
            for lo, h2, hi in zip(sub_lo, sub_hi, c_hi)
        ]
    invz = iz_lo + s_star * (iz_hi - iz_lo)
    for ch in range(4):
        out_ref[ch] = jnp.where(found, rgba[ch], 0.0)
    out_ref[4] = jnp.where(found, invz, 0.0)
    out_ref[5] = found.astype(jnp.float32)


@functools.partial(
    jax.jit, static_argnames=("plan", "num_planes", "refine", "interpret")
)
def _march_lateral(src, tx_t, iy_t, iz_t, izmin, izmax, *,
                   plan: TranslationPlan, num_planes: int, refine: int,
                   interpret: bool = False):
    """(found, invz_star, rgba_star) of a pose batch from the padded
    source and the per-pose (B, K) plane tables."""
    batch = tx_t.shape[0]
    hp, wp = _round_up(plan.out_h, TILE_H), _round_up(plan.out_w, TILE_W)
    # rows r + iy and columns c + ix + 1 with iy < tab_span_y, ix < tab_span_x
    assert src.shape[1] >= hp + plan.tab_span_y, (src.shape, plan)
    assert src.shape[2] >= wp + plan.tab_span_x, (src.shape, plan)
    out = pl.pallas_call(
        functools.partial(_kernel, num_planes=num_planes, refine=refine),
        grid=(batch, hp // TILE_H, wp // TILE_W),
        out_specs=pl.BlockSpec(
            (None, 8, TILE_H, TILE_W), lambda p, i, j: (p, 0, i, j)
        ),
        out_shape=jax.ShapeDtypeStruct((batch, 8, hp, wp), jnp.float32),
        backend="triton",
        compiler_params=pltriton.CompilerParams(
            num_warps=_NUM_WARPS, num_stages=1
        ),
        interpret=interpret,
        name="lateral_snap_march",
    )(
        tx_t, iy_t, iz_t,
        jnp.stack([izmin, izmax]).astype(jnp.float32),
        src,
    )
    out = out[:, :, : plan.out_h, : plan.out_w]
    return out[:, 5], out[:, 4], jnp.moveaxis(out[:, :4], 1, -1)


@functools.partial(
    jax.jit,
    static_argnames=(
        "plan", "num_planes", "mask_mode", "to_srgb", "refine", "raw",
        "crop_y", "interpret",
    ),
)
def render_translation_batch_gpu(
    rgb,
    disp,
    mask,
    invz_min,
    invz_max,
    c1,  # (B, 3) lateral: c1[:, 1] == c1[:, 2] == 0
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
    interpret: bool = False,
):
    """Batched lateral march through the kernel; arguments as
    sweep_march.render_translation_batch. `prepared` is the hoisted
    prepare_lateral_source stack (rgb/disp/mask are then unused).
    Returns (B, H, W, 4), or the raw per-pose tuples."""
    izmin = jnp.asarray(invz_min, jnp.float32)
    izmax = jnp.asarray(invz_max, jnp.float32)
    c1 = jnp.asarray(c1, jnp.float32)
    invz = jnp.asarray(plane_invz, jnp.float32)
    if invz.ndim == 1:
        invz = jnp.broadcast_to(invz, (c1.shape[0], invz.shape[0]))
    ix_t, fx_t, iy_t, _ = jax.vmap(
        lambda cc, pp: plane_tables(plan, pp, cc, f1, dx=offset[0])
    )(c1, invz)
    if prepared is None:
        prepared = prepare_lateral_source(rgb, disp, mask, plan)
    found, invz_star, rgba_star = _march_lateral(
        prepared, ix_t.astype(jnp.float32) + fx_t, iy_t, invz, izmin, izmax,
        plan=plan, num_planes=num_planes, refine=refine, interpret=interpret,
    )
    return jax.vmap(
        lambda f, r, rg, cc: _finalize(
            plan, f, r, rg, cc, f1, izmin, background, feathering,
            mask_mode, to_srgb, raw=raw, offset=offset, crop_y=crop_y,
        )
    )(found, invz_star, rgba_star, c1)
