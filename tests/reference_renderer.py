"""Independent float64 numpy implementation of the reference ray-march.

This file is the *golden oracle* for the JAX kernels: it is written directly
from the GLSL specification (reference: src/shaders/rayCastMonoLDI.glsl and
rayCastStereoLDI.glsl), shares no code with lif_tpu, and runs in float64.
Golden-image tests compare the render kernels against this at >= 40 dB PSNR
(the BASELINE.json fidelity gate).

Textures are GL-oriented arrays (row 0 = v0 = bottom), uv in [0,1]^2.
"""

from __future__ import annotations

import numpy as np

NUM_STEPS = 40


# --- samplers (GL LINEAR + CLAMP_TO_EDGE) -------------------------------

def sample_bilinear(tex, u, v, res_w, res_h):
    sx = u * res_w - 0.5
    sy = v * res_h - 0.5
    x0 = np.floor(sx)
    y0 = np.floor(sy)
    fx = sx - x0
    fy = sy - y0
    ix0 = np.clip(x0.astype(np.int64), 0, int(res_w) - 1)
    ix1 = np.clip(x0.astype(np.int64) + 1, 0, int(res_w) - 1)
    iy0 = np.clip(y0.astype(np.int64), 0, int(res_h) - 1)
    iy1 = np.clip(y0.astype(np.int64) + 1, 0, int(res_h) - 1)
    if tex.ndim == 3:
        fx = fx[..., None]
        fy = fy[..., None]
    t00 = tex[iy0, ix0]
    t01 = tex[iy0, ix1]
    t10 = tex[iy1, ix0]
    t11 = tex[iy1, ix1]
    top = t00 * (1 - fx) + t01 * fx
    bot = t10 * (1 - fx) + t11 * fx
    return top * (1 - fy) + bot * fy


def read_disp(disp, u, v, v_min, v_max, res_w, res_h):
    uc = np.clip(u, 2.0 / res_w, 1.0 - 2.0 / res_w)
    vc = np.clip(v, 2.0 / res_h, 1.0 - 2.0 / res_h)
    return sample_bilinear(disp, uc, vc, res_w, res_h) * (v_min - v_max) + v_max


# --- matrix builders (row-major translations of the GLSL column-major) ---

def mat_from_skew(sk):
    return np.array([[1.0, 0.0, -sk[0]], [0.0, 1.0, -sk[1]], [0.0, 0.0, 1.0]])


def mat_from_focal(fx, fy):
    return np.diag([fx, fy, 1.0])


def mat_from_slant(sl):
    invsqx = 1.0 / np.sqrt(1.0 + sl[0] ** 2)
    invsqy = 1.0 / np.sqrt(1.0 + sl[1] ** 2)
    invsq = 1.0 / np.sqrt(1.0 + sl[0] ** 2 + sl[1] ** 2)
    return np.array(
        [
            [invsqx, 0.0, -sl[0] * invsqx],
            [0.0, invsqy, -sl[1] * invsqy],
            [sl[0] * invsq, sl[1] * invsq, invsq],
        ]
    )


def mat_from_roll(th_deg):
    pi = 3.141593
    c = np.cos(th_deg * pi / 180.0)
    s = np.sin(th_deg * pi / 180.0)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


FLIP_Z = np.diag([1.0, 1.0, -1.0])


def smoothstep(e0, e1, x):
    t = np.clip((x - e0) / (e1 - e0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def taper(u, v, feathering):
    return (
        smoothstep(0.0, feathering, u)
        * (1.0 - smoothstep(1.0 - feathering, 1.0, u))
        * smoothstep(0.0, feathering, v)
        * (1.0 - smoothstep(1.0 - feathering, 1.0, v))
    )


def linear_to_srgb(x):
    return np.where(
        x <= 0.0031308, x * 12.92, 1.055 * np.power(np.maximum(x, 0.0), 1 / 2.4) - 0.055
    )


# --- the march (rayCastMonoLDI.glsl:219-297) ------------------------------

def raycasting(
    s2x,
    s2y,
    fskr2,
    c2,
    fskr1,
    c1,
    rgb,
    disp,
    mask,
    invz_min,
    invz_max,
    res_w,
    res_h,
    t,
    background_rgb,
    feathering,
    mask_mode="multiply",
):
    """Vectorized float64 port of the GLSL raycasting() for a pixel grid."""
    numsteps = float(NUM_STEPS)

    invz = np.full_like(s2x, invz_min)
    dinvz = np.full_like(s2x, (invz_min - invz_max) / numsteps)
    invz_min_t = invz_min * (1.0 - t)
    invz = invz + dinvz  # step back once before start

    invz2 = np.zeros_like(s2x)
    old_disp = np.zeros_like(s2x)
    grad_thr = 0.02 * (invz_min - invz_max) * 140.0 / numsteps

    p = fskr1 @ np.linalg.inv(fskr2)
    c = fskr1 @ (c2 - c1)

    pxyxy = p[:2, :2]
    pxyz = p[:2, 2]
    pzxy = p[2, :2]
    pzz = p[2, 2]

    denom = pzxy[0] * s2x + pzxy[1] * s2y + pzz
    qx = (pxyxy[0, 0] * s2x + pxyxy[0, 1] * s2y + pxyz[0]) / denom
    qy = (pxyxy[1, 0] * s2x + pxyxy[1, 1] * s2y + pxyz[1]) / denom

    s1x = c[0] * invz + (1.0 - c[2] * invz) * qx
    s1y = c[1] * invz + (1.0 - c[2] * invz) * qy
    ds1x = (c[0] - c[2] * qx) * dinvz
    ds1y = (c[1] - c[2] * qy) * dinvz

    confidence = np.ones_like(s2x)

    for _ in range(NUM_STEPS):
        invz = invz - dinvz
        s1x = s1x - ds1x
        s1y = s1y - ds1y
        d = read_disp(disp, s1x + 0.5, s1y + 0.5, invz_min, invz_max, res_w, res_h)
        grad = d - old_disp
        old_disp = d
        invz2 = invz * denom / (1.0 - c[2] * invz)
        below = (d > invz) & (invz2 > 0.0)
        confidence = np.where(below & (np.abs(grad) > grad_thr), 0.0, confidence)
        invz = np.where(below, invz + dinvz, invz)
        s1x = np.where(below, s1x + ds1x, s1x)
        s1y = np.where(below, s1y + ds1y, s1y)
        dinvz = np.where(below, dinvz * 0.5, dinvz)
        ds1x = np.where(below, ds1x * 0.5, ds1x)
        ds1y = np.where(below, ds1y * 0.5, ds1y)

    if mask_mode == "dilated_discard":
        invz2_ok = invz2 >= 0.0
    else:
        invz2_ok = invz2 > 0.0
    hit = (np.abs(s1x) < 0.5) & (np.abs(s1y) < 0.5) & invz2_ok & (invz > invz_min_t)

    u1 = s1x + 0.5
    v1 = s1y + 0.5
    color = sample_bilinear(rgb, u1, v1, res_w, res_h)
    tap = taper(u1, v1, feathering)

    if mask_mode == "multiply":
        alpha = tap * sample_bilinear(mask, u1, v1, res_w, res_h)
        conf_hit = tap
    elif mask_mode == "dilated_discard":
        masked = np.zeros_like(s2x, dtype=bool)
        for dy in (-1.0, 0.0, 1.0):
            for dx in (-1.0, 0.0, 1.0):
                mv = sample_bilinear(
                    mask, u1 + 1.5 * dx / res_w, v1 + 1.5 * dy / res_h, res_w, res_h
                )
                masked |= mv < 0.5
        alpha = np.where(masked, 0.0, tap)
        color = np.where(masked[..., None], 0.0, color)
        conf_hit = confidence
    elif mask_mode == "none":
        alpha = tap
        conf_hit = confidence
    else:
        raise ValueError(mask_mode)

    rgb_out = np.where(hit[..., None], color, np.broadcast_to(background_rgb, color.shape))
    a_out = np.where(hit, alpha, 0.0)
    invz2_out = np.where(hit, invz2, 0.0)
    if mask_mode == "dilated_discard":
        conf_out = conf_hit
    else:
        conf_out = np.where(hit, conf_hit, 0.0)
    rgba = np.concatenate([rgb_out, a_out[..., None]], axis=-1)
    return rgba, invz2_out, conf_out


def render_mono_reference(
    layers,
    skew1,
    c1,
    rot1,
    f2,
    skew2,
    out_w,
    out_h,
    background=(0, 0, 0, 0),
    feathering=0.1,
    mask_mode="multiply",
    to_srgb=True,
):
    """Full mono render: rayCastMonoLDI main() in float64 numpy.

    layers: list of dicts with keys rgb (H,W,3 linear), disp (H,W),
      mask (H,W), res (w,h), invz_min, invz_max, focal (all
      baseline-normalized invz).
    c1/rot1: projector pose in camera-local space (Z-negated position).
    """
    u = (np.arange(out_w, dtype=np.float64) + 0.5) / out_w
    v = (np.arange(out_h, dtype=np.float64) + 0.5) / out_h
    s2x = np.broadcast_to(u[None, :], (out_h, out_w)) - 0.5
    s2y = np.broadcast_to(v[:, None], (out_h, out_w)) - 0.5

    background = np.asarray(background, dtype=np.float64)

    skr1 = mat_from_skew(skew1) @ (FLIP_Z @ np.asarray(rot1).T @ FLIP_Z)
    fskr2 = (
        mat_from_focal(f2 / out_w, f2 / out_h) @ mat_from_skew(skew2)
    )  # camera rotation identity in camera-local frame
    c2 = np.zeros(3)
    c1 = np.asarray(c1, dtype=np.float64)

    result_rgb = None
    result_a = None
    for layer in layers:
        res_w, res_h = layer["res"]
        fskr1 = mat_from_focal(layer["focal"] / res_w, layer["focal"] / res_h) @ skr1
        rgba, _, _ = raycasting(
            s2x,
            s2y,
            fskr2,
            c2,
            fskr1,
            c1,
            layer["rgb"],
            layer["disp"],
            layer["mask"],
            layer["invz_min"],
            layer["invz_max"],
            res_w,
            res_h,
            1.0,
            background[:3],
            feathering,
            mask_mode=mask_mode,
        )
        if result_rgb is None:
            result_rgb = rgba[..., :3] * rgba[..., 3:4]
            result_a = rgba[..., 3]
        else:
            la = rgba[..., 3]
            result_rgb = result_rgb + (1.0 - result_a[..., None]) * la[..., None] * rgba[..., :3]
            result_a = la + result_a * (1.0 - la)

    result_rgb = background[:3] * background[3] * (1.0 - result_a[..., None]) + result_rgb
    result_a = background[3] + result_a * (1.0 - background[3])

    if to_srgb:
        result_rgb = linear_to_srgb(result_rgb)
    return np.concatenate([result_rgb, result_a[..., None]], axis=-1)


def weight2(c, c1, c2):
    """Stereo view weight. reference: rayCastStereoLDI.glsl:165-170."""
    num = np.dot(c2 - c1, c - c1)
    den = np.dot(c2 - c1, c2 - c1)
    return smoothstep(0.0, 1.0, num / den)


def render_stereo_reference(
    layers_l,
    layers_r,
    skew1_l,
    c1_l,
    rot1_l,
    skew1_r,
    c1_r,
    rot1_r,
    f2,
    skew2,
    out_w,
    out_h,
    background=(0, 0, 0, 0),
    feathering=0.1,
    to_srgb=True,
):
    """rayCastStereoLDI main() in float64 numpy (occlusion fill + blend).
    reference: rayCastStereoLDI.glsl:321-450."""
    u = (np.arange(out_w, dtype=np.float64) + 0.5) / out_w
    v = (np.arange(out_h, dtype=np.float64) + 0.5) / out_h
    s2x = np.broadcast_to(u[None, :], (out_h, out_w)) - 0.5
    s2y = np.broadcast_to(v[:, None], (out_h, out_w)) - 0.5

    background = np.asarray(background, dtype=np.float64)
    skr1_l = mat_from_skew(skew1_l) @ (FLIP_Z @ np.asarray(rot1_l).T @ FLIP_Z)
    skr1_r = mat_from_skew(skew1_r) @ (FLIP_Z @ np.asarray(rot1_r).T @ FLIP_Z)
    fskr2 = mat_from_focal(f2 / out_w, f2 / out_h) @ mat_from_skew(skew2)
    c2 = np.zeros(3)
    c1_l = np.asarray(c1_l, dtype=np.float64)
    c1_r = np.asarray(c1_r, dtype=np.float64)

    w_r = weight2(c2, c1_l, c1_r)

    result_rgb = None
    result_a = None
    for layer_l, layer_r in zip(layers_l, layers_r):
        rw_l, rh_l = layer_l["res"]
        rw_r, rh_r = layer_r["res"]
        fskr1_l = mat_from_focal(layer_l["focal"] / rw_l, layer_l["focal"] / rh_l) @ skr1_l
        fskr1_r = mat_from_focal(layer_r["focal"] / rw_r, layer_r["focal"] / rh_r) @ skr1_r
        rgba_l, _, a_l = raycasting(
            s2x, s2y, fskr2, c2, fskr1_l, c1_l,
            layer_l["rgb"], layer_l["disp"], layer_l["mask"],
            layer_l["invz_min"], layer_l["invz_max"], rw_l, rh_l,
            1.0, background[:3], feathering, mask_mode="dilated_discard",
        )
        rgba_r, _, a_r = raycasting(
            s2x, s2y, fskr2, c2, fskr1_r, c1_r,
            layer_r["rgb"], layer_r["disp"], layer_r["mask"],
            layer_r["invz_min"], layer_r["invz_max"], rw_r, rh_r,
            1.0, background[:3], feathering, mask_mode="dilated_discard",
        )
        # Occlusion fill, sequential like the GLSL: the right-view test reads
        # the possibly-already-filled left layer. reference:
        # rayCastStereoLDI.glsl:372-381.
        fill_l = ((a_l == 0.0) & (a_r == 1.0)) | (rgba_l[..., 3] < rgba_r[..., 3] - 0.1)
        rgba_l2 = np.where(fill_l[..., None], rgba_r, rgba_l)
        fill_r = ((a_r == 0.0) & (a_l == 1.0)) | (rgba_r[..., 3] < rgba_l2[..., 3] - 0.1)
        rgba_r2 = np.where(fill_r[..., None], rgba_l2, rgba_r)
        layer = (1.0 - w_r) * rgba_l2 + w_r * rgba_r2
        if result_rgb is None:
            result_rgb = layer[..., :3] * layer[..., 3:4]
            result_a = layer[..., 3]
        else:
            la = layer[..., 3]
            result_rgb = result_rgb + (1.0 - result_a[..., None]) * la[..., None] * layer[..., :3]
            result_a = la + result_a * (1.0 - la)

    result_rgb = background[:3] * background[3] * (1.0 - result_a[..., None]) + result_rgb
    result_a = background[3] + result_a * (1.0 - background[3])
    if to_srgb:
        result_rgb = linear_to_srgb(result_rgb)
    return np.concatenate([result_rgb, result_a[..., None]], axis=-1)


def psnr(a, b, peak=1.0):
    mse = np.mean((np.asarray(a, dtype=np.float64) - np.asarray(b, dtype=np.float64)) ** 2)
    if mse == 0:
        return np.inf
    return 10.0 * np.log10(peak * peak / mse)
