"""WebGL-faithful texture sampling as XLA gathers.

Semantics reproduced:
  * LinearFilter + ClampToEdgeWrapping bilinear: sample position
    ``st = uv * res - 0.5``, texel indices clamped to [0, res-1]
    (matches the GL spec for CLAMP_TO_EDGE linear filtering).
  * NearestFilter: ``floor(uv * res)`` clamped.
  * readDisp's 2-texel interior clamp before sampling
    (reference: src/shaders/rayCastMonoLDI.glsl:59-61).

Textures are stored GL-oriented (row 0 = v=0 = image bottom); uv is the GL
texture coordinate in [0,1]^2. Logical resolution ``res=(w, h)`` may be
smaller than the stored array (padded layers); the pad region is never
addressed because indices clamp to the logical extent.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = [
    "bilinear_sample",
    "bilinear_sample_packed",
    "nearest_sample",
    "pack_rgbm",
    "read_disp",
]


def _opaque(*idx):
    """Identity hook for gather indices (kept as a single choke point).

    Plain indices: an optimization barrier here would split the fused
    march step.
    """
    return idx


def _gather(tex, iy, ix):
    """tex: (H, W) or (H, W, C); iy/ix: integer index arrays of equal shape.

    Implemented as a FLAT 1-D take (iy*W + ix into a reshaped texture):
    2-D advanced indexing lowers to a multi-index-vector gather; a flat
    take stays a single plain gather no matter how callers batch the
    index arithmetic.
    """
    h, w = tex.shape[0], tex.shape[1]
    # Flatten BOTH the texture and the index array to 1-D: gather
    # lowerings are shape-sensitive, and flat take + reshape is the one
    # form that stays a plain gather.
    out_shape = iy.shape
    flat_idx = (iy * w + ix).reshape(-1)
    if tex.ndim == 2:
        return jnp.take(tex.reshape(h * w), flat_idx).reshape(out_shape)
    # (H, W, C): one flat take per channel (channel count is tiny/static).
    flat = tex.reshape(h * w, tex.shape[2])
    return jnp.stack(
        [
            jnp.take(flat[:, c], flat_idx).reshape(out_shape)
            for c in range(tex.shape[2])
        ],
        axis=-1,
    )


def _patch_table(tex):
    """(H, W[, C]) -> (H*W, 4[, C]) rows of the 2x2 texel patch anchored at
    each texel: [t(y,x), t(y,x+1), t(y+1,x), t(y+1,x+1)], stored-edge
    replicated.

    Why: one 4-wide ROW gather replaces four separate flat takes, so a
    bilinear fetch becomes ONE indexed op. The build is a pad+stack
    (memory-bound) that XLA hoists/CSEs out of unrolled sampling
    loops."""
    pads = ((0, 1), (0, 1)) + ((0, 0),) * (tex.ndim - 2)
    p = jnp.pad(tex, pads, mode="edge")
    h, w = tex.shape[0], tex.shape[1]
    quad = jnp.stack(
        [p[:-1, :-1], p[:-1, 1:], p[1:, :-1], p[1:, 1:]], axis=2
    )  # (H, W, 4[, C])
    return quad.reshape((h * w, 4) + tex.shape[2:])


def _edge_weights(x0, y0, fx, fy, wmax, hmax):
    """Zero the lerp weight wherever the old per-tap clamping collapsed
    both taps onto the same texel (sample left of texel 0's center or at
    the logical right/top edge) — the patch row's neighbour entry may lie
    beyond the LOGICAL extent there, so it must get weight 0. Matches the
    clamped 4-tap formulation bit-for-bit."""
    fx = jnp.where((x0 >= 0) & (x0 < wmax), fx, 0.0)
    fy = jnp.where((y0 >= 0) & (y0 < hmax), fy, 0.0)
    return fx, fy


def bilinear_sample(tex, u, v, res_w, res_h):
    """Bilinear sample with clamp-to-edge.

    Args:
      tex: (H, W) or (H, W, C) array, GL-oriented.
      u, v: sample coordinates in [0, 1], any broadcast-compatible shape.
      res_w, res_h: logical texture resolution (<= stored array dims).

    Returns array of shape ``u.shape`` (+ channel dim if tex has one).
    Implemented as ONE 4-wide row gather of a precomputed 2x2-patch table
    (see _patch_table) instead of four flat takes.
    """
    sx = u * res_w - 0.5
    sy = v * res_h - 0.5
    x0 = jnp.floor(sx).astype(jnp.int32)
    y0 = jnp.floor(sy).astype(jnp.int32)
    fx = sx - jnp.floor(sx)
    fy = sy - jnp.floor(sy)

    wmax = jnp.asarray(res_w).astype(jnp.int32) - 1
    hmax = jnp.asarray(res_h).astype(jnp.int32) - 1
    fx, fy = _edge_weights(x0, y0, fx, fy, wmax, hmax)
    ix0 = jnp.clip(x0, 0, wmax)
    iy0 = jnp.clip(y0, 0, hmax)
    (flat_idx,) = _opaque((iy0 * tex.shape[1] + ix0).reshape(-1))

    quad = jnp.take(_patch_table(tex), flat_idx, axis=0)
    out_shape = u.shape
    if tex.ndim == 3:
        quad = quad.reshape(out_shape + (4, tex.shape[2]))
        fx = fx[..., None]
        fy = fy[..., None]
    else:
        quad = quad.reshape(out_shape + (4,))
    if tex.ndim == 3:
        t00, t01, t10, t11 = (
            quad[..., 0, :], quad[..., 1, :], quad[..., 2, :], quad[..., 3, :]
        )
    else:
        t00, t01, t10, t11 = (
            quad[..., 0], quad[..., 1], quad[..., 2], quad[..., 3]
        )
    top = t00 + (t01 - t00) * fx
    bot = t10 + (t11 - t10) * fx
    return top + (bot - top) * fy


def nearest_sample(tex, u, v, res_w, res_h):
    """Nearest-neighbour sample with clamp-to-edge (GL NEAREST)."""
    wmax = jnp.asarray(res_w).astype(jnp.int32) - 1
    hmax = jnp.asarray(res_h).astype(jnp.int32) - 1
    ix = jnp.clip(jnp.floor(u * res_w).astype(jnp.int32), 0, wmax)
    iy = jnp.clip(jnp.floor(v * res_h).astype(jnp.int32), 0, hmax)
    ix, iy = _opaque(ix, iy)
    return _gather(tex, iy, ix)


def pack_rgbm(rgb, mask):
    """Pack (H, W, 3) rgb in [0,1] + (H, W) mask into one int32 channel:
    10 bits per color + 1 mask bit: one single-channel gather instead of
    four per-channel ones."""
    q = jnp.clip(jnp.round(rgb * 1023.0), 0, 1023).astype(jnp.int32)
    m = (mask > 0.5).astype(jnp.int32)
    return (q[..., 0] << 21) | (q[..., 1] << 11) | (q[..., 2] << 1) | m


def _unpack_rgbm(packed):
    r = ((packed >> 21) & 1023).astype(jnp.float32) / 1023.0
    g = ((packed >> 11) & 1023).astype(jnp.float32) / 1023.0
    b = ((packed >> 1) & 1023).astype(jnp.float32) / 1023.0
    m = (packed & 1).astype(jnp.float32)
    return jnp.stack([r, g, b, m], axis=-1)


def bilinear_sample_packed(packed_tex, u, v, res_w, res_h):
    """Bilinear sample of a pack_rgbm texture: ONE 4-wide int32 row gather
    of the 2x2-patch table, unpack, blend. Returns (..., 4) =
    [r, g, b, mask]."""
    sx = u * res_w - 0.5
    sy = v * res_h - 0.5
    x0 = jnp.floor(sx).astype(jnp.int32)
    y0 = jnp.floor(sy).astype(jnp.int32)
    fx = sx - jnp.floor(sx)
    fy = sy - jnp.floor(sy)
    wmax = jnp.asarray(res_w).astype(jnp.int32) - 1
    hmax = jnp.asarray(res_h).astype(jnp.int32) - 1
    fx, fy = _edge_weights(x0, y0, fx, fy, wmax, hmax)
    fx = fx[..., None]
    fy = fy[..., None]
    ix0 = jnp.clip(x0, 0, wmax)
    iy0 = jnp.clip(y0, 0, hmax)
    (flat_idx,) = _opaque((iy0 * packed_tex.shape[1] + ix0).reshape(-1))

    quad = jnp.take(_patch_table(packed_tex), flat_idx, axis=0).reshape(
        u.shape + (4,)
    )
    t00 = _unpack_rgbm(quad[..., 0])
    t01 = _unpack_rgbm(quad[..., 1])
    t10 = _unpack_rgbm(quad[..., 2])
    t11 = _unpack_rgbm(quad[..., 3])
    top = t00 + (t01 - t00) * fx
    bot = t10 + (t11 - t10) * fx
    return top + (bot - top) * fy


def read_disp(disp_tex, u, v, v_min, v_max, res_w, res_h):
    """Decode inverse depth from a disparity texture.

    Clamps uv to a 2-texel interior border, bilinearly samples the first
    channel, then maps [0,1] -> [v_max, v_min]:
    ``texel * (vMin - vMax) + vMax``.
    reference: rayCastMonoLDI.glsl:59-61.
    """
    uc = jnp.clip(u, 2.0 / res_w, 1.0 - 2.0 / res_w)
    vc = jnp.clip(v, 2.0 / res_h, 1.0 - 2.0 / res_h)
    texel = bilinear_sample(disp_tex, uc, vc, res_w, res_h)
    if texel.ndim > jnp.ndim(u):  # multi-channel: disparity is channel 0
        texel = texel[..., 0]
    return texel * (v_min - v_max) + v_max
