"""3x3 projective-transform builders for view synthesis.

These are the row-major equivalents of the GLSL helpers in the reference
renderer (reference: src/shaders/rayCastMonoLDI.glsl:63-97). GLSL mat3
constructors are column-major; every builder here returns the row-major
matrix that performs the same ``M @ v`` product.

All functions accept python floats, numpy arrays or jnp arrays and are
jit/vmap safe.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# All matrices here are 3x3: force full-precision f32 matmuls (a GPU
# runs a bare f32 matmul in TF32, which keeps ~3 decimal digits and would
# eat the 40 dB PSNR budget).
_PRECISION = jax.lax.Precision.HIGHEST


def mm(a, b):
    """3x3 matmul at HIGHEST precision."""
    return jnp.matmul(a, b, precision=_PRECISION)

__all__ = [
    "FLIP_Z",
    "mat_from_slant",
    "mat_from_roll",
    "mat_from_skew",
    "mat_from_focal",
    "inv3",
    "shader_rotation",
]

# Z-axis flip: converts between -Z-forward (scene convention, as in THREE)
# and +Z-forward (shader convention). reference: rayCastMonoLDI.glsl:97
#
# Deliberately a NUMPY constant: a module-level jnp array would live on the
# default device and be captured by every jitted function as a device
# buffer; numpy constants are inlined into the jaxpr as literals.
FLIP_Z = np.diag(np.array([1.0, 1.0, -1.0], dtype=np.float32))


def mat_from_slant(sl_x, sl_y):
    """Rotation from tangent-space slant. reference: rayCastMonoLDI.glsl:63-71.

    GLSL columns (invsqx,0,slx*invsq), (0,invsqy,sly*invsq),
    (-slx*invsqx,-sly*invsqy,invsq) transposed to row-major.
    """
    sl_x = jnp.asarray(sl_x, dtype=jnp.float32)
    sl_y = jnp.asarray(sl_y, dtype=jnp.float32)
    invsqx = 1.0 / jnp.sqrt(1.0 + sl_x * sl_x)
    invsqy = 1.0 / jnp.sqrt(1.0 + sl_y * sl_y)
    invsq = 1.0 / jnp.sqrt(1.0 + sl_x * sl_x + sl_y * sl_y)
    zero = jnp.zeros_like(sl_x)
    return jnp.stack(
        [
            jnp.stack([invsqx, zero, -sl_x * invsqx], axis=-1),
            jnp.stack([zero, invsqy, -sl_y * invsqy], axis=-1),
            jnp.stack([sl_x * invsq, sl_y * invsq, invsq], axis=-1),
        ],
        axis=-2,
    )


def mat_from_roll(roll_degrees):
    """Roll about +Z, angle in degrees. reference: rayCastMonoLDI.glsl:73-81.

    Uses the shader's truncated PI constant (3.141593) so golden values
    reproduce the GLSL output bit-for-bit at f32.
    """
    th = jnp.asarray(roll_degrees, dtype=jnp.float32)
    pi = jnp.float32(3.141593)
    c = jnp.cos(th * pi / 180.0)
    s = jnp.sin(th * pi / 180.0)
    zero = jnp.zeros_like(c)
    one = jnp.ones_like(c)
    return jnp.stack(
        [
            jnp.stack([c, -s, zero], axis=-1),
            jnp.stack([s, c, zero], axis=-1),
            jnp.stack([zero, zero, one], axis=-1),
        ],
        axis=-2,
    )


def mat_from_skew(sk_x, sk_y):
    """Frustum-skew shear from tangent angles. reference: rayCastMonoLDI.glsl:83-88.

    Row-major: [[1,0,-skx],[0,1,-sky],[0,0,1]].
    """
    sk_x = jnp.asarray(sk_x, dtype=jnp.float32)
    sk_y = jnp.asarray(sk_y, dtype=jnp.float32)
    zero = jnp.zeros_like(sk_x)
    one = jnp.ones_like(sk_x)
    return jnp.stack(
        [
            jnp.stack([one, zero, -sk_x], axis=-1),
            jnp.stack([zero, one, -sk_y], axis=-1),
            jnp.stack([zero, zero, one], axis=-1),
        ],
        axis=-2,
    )


def mat_from_focal(f_x, f_y):
    """Focal scaling, f expressed as a fraction of the image dimension.
    reference: rayCastMonoLDI.glsl:90-95."""
    f_x = jnp.asarray(f_x, dtype=jnp.float32)
    f_y = jnp.asarray(f_y, dtype=jnp.float32)
    zero = jnp.zeros_like(f_x)
    one = jnp.ones_like(f_x)
    return jnp.stack(
        [
            jnp.stack([f_x, zero, zero], axis=-1),
            jnp.stack([zero, f_y, zero], axis=-1),
            jnp.stack([zero, zero, one], axis=-1),
        ],
        axis=-2,
    )


def inv3(m):
    """Closed-form 3x3 inverse via the adjugate.

    jnp.linalg.inv lowers to an LU custom-call; the adjugate is a handful
    of elementwise ops that fuse into the caller.
    Mirrors the GLSL ES fallback (reference: rayCastMonoLDI.glsl:119-129).
    """
    m = jnp.asarray(m)
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    co_a = e * i - f * h
    co_b = f * g - d * i
    co_c = d * h - e * g
    det = a * co_a + b * co_b + c * co_c
    adj = jnp.stack(
        [
            jnp.stack([co_a, c * h - b * i, b * f - c * e], axis=-1),
            jnp.stack([co_b, a * i - c * g, c * d - a * f], axis=-1),
            jnp.stack([co_c, b * g - a * h, a * e - b * d], axis=-1),
        ],
        axis=-2,
    )
    return adj / det[..., None, None]


def shader_rotation(rotation):
    """Convert a camera-local rotation matrix (scene convention, -Z forward)
    into the shader's +Z-forward frame: ``flipZ @ R.T @ flipZ``.
    reference: rayCastMonoLDI.glsl:316, 332."""
    rotation = jnp.asarray(rotation, dtype=jnp.float32)
    rt = jnp.swapaxes(rotation, -1, -2)
    return mm(mm(FLIP_Z, rt), FLIP_Z)
