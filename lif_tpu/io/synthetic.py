"""Seeded procedural stand-in for the flagship demo scene.

The reference demo's default scene is a 1280x800 photo plus an 8-bit
inverse-depth map (reference: index.html:142-168). Its constants are
kept here: focal 0.78 * W, centered principal point, inverse depth in
[0.0001, 0.09] 1/m, baseline 0.045 m, convergence at invd = 0.045. The
content is generated from a seed, so no asset has to be shipped or
downloaded, and it carries the properties that set the cost and the
fidelity of the render tiers:

  * the full inverse-depth range: a far opening one 8-bit level above
    the far plane behind a room whose floor runs up to disparity 0.9
    (the snap-plane count scales with f * |c| * range);
  * occlusion edges: boxes, the opening and the poles are depth steps,
    softened over a few pixels as an estimated depth map has them, so
    every tier meets disocclusion stretch;
  * thin structures: poles 6-10 px wide at mid depth and a 3 px rail;
  * textured surfaces: multi-octave value noise, bricks on the back wall
    and a checker floor, so a mislocated crossing shows up in colour.

Arrays are linear-light float32 in GL orientation (row 0 = bottom), the
layout `projector_from_arrays` takes.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

__all__ = [
    "FLAGSHIP_W",
    "FLAGSHIP_H",
    "FlagshipScene",
    "flagship_scene",
    "flagship_projector",
    "flagship_orbit_center",
]

FLAGSHIP_W, FLAGSHIP_H = 1280, 800
FOCAL_RATIO = 0.78  # focal_px / width
INVZ_MIN, INVZ_MAX = 0.09, 0.0001  # 1/m, near and far
BASELINE_M = 0.045
INVD = 0.045  # convergence: depth baseline / invd = 1 m
# the far opening sits one 8-bit level above the far plane: a surface at
# exactly disparity 0 lies on the march's far bound, where first-crossing
# is undefined
_FAR_DISP = 1.0 / 255.0
# passes of the edge blur at full size (scaled down with the image)
_SOFTEN = 6


class FlagshipScene(NamedTuple):
    rgb: np.ndarray  # (H, W, 3) float32 linear, GL-oriented
    disp: np.ndarray  # (H, W) float32 normalized inverse depth in [0, 1]
    focal_px: float
    invz_min: float
    invz_max: float
    baseline: float


def _value_noise(rng, h, w, cells, octaves=4):
    """Band-limited noise in [0, 1]: bilinear upsampling of random grids,
    `cells` grid cells across the width at the coarsest octave."""
    acc = np.zeros((h, w), np.float32)
    amp, total = 1.0, 0.0
    for o in range(octaves):
        gw = max(2, int(cells * 2**o) + 1)
        gh = max(2, int(round(gw * h / w)) + 1)
        grid = rng.random((gh, gw)).astype(np.float32)
        ys = np.linspace(0, gh - 1, h, dtype=np.float32)
        xs = np.linspace(0, gw - 1, w, dtype=np.float32)
        y0 = np.minimum(ys.astype(np.int64), gh - 2)
        x0 = np.minimum(xs.astype(np.int64), gw - 2)
        fy = (ys - y0)[:, None]
        fx = (xs - x0)[None, :]
        top = grid[y0][:, x0] * (1 - fx) + grid[y0][:, x0 + 1] * fx
        bot = grid[y0 + 1][:, x0] * (1 - fx) + grid[y0 + 1][:, x0 + 1] * fx
        acc += amp * (top * (1 - fy) + bot * fy)
        total += amp
        amp *= 0.5
    return acc / total


def _soften(d, passes):
    """Separable [1, 2, 1] / 4 blur, edge-replicated: depth edges as an
    estimated depth map has them, soft over a couple of pixels."""
    for _ in range(passes):
        p = np.pad(d, 1, mode="edge")
        d = (p[1:-1, :-2] + 2 * p[1:-1, 1:-1] + p[1:-1, 2:]) / 4
        p = np.pad(d, 1, mode="edge")
        d = (p[:-2, 1:-1] + 2 * p[1:-1, 1:-1] + p[2:, 1:-1]) / 4
    return d


def flagship_scene(seed: int = 0, scale: int = 1) -> FlagshipScene:
    """The seeded flagship scene at (1280 / scale) x (800 / scale).

    Geometry is defined in normalized image coordinates, so every scale
    shows the same room; `seed` moves the boxes and poles and redraws
    every texture. Deterministic for a given (seed, scale)."""
    rgb, disp = _draw(seed, FLAGSHIP_W // scale, FLAGSHIP_H // scale)
    return FlagshipScene(
        rgb=np.ascontiguousarray(rgb, np.float32),
        disp=np.ascontiguousarray(disp, np.float32),
        focal_px=FOCAL_RATIO * (FLAGSHIP_W // scale),
        invz_min=INVZ_MIN,
        invz_max=INVZ_MAX,
        baseline=BASELINE_M,
    )


def _draw(seed, w, h):
    rng = np.random.default_rng(seed)
    u = (np.arange(w, dtype=np.float32) + 0.5) / w  # 0 = left
    v = (np.arange(h, dtype=np.float32) + 0.5) / h  # 0 = bottom (GL)
    uu, vv = np.meshgrid(u, v)

    def tex(color, cells, contrast=0.5):
        n = _value_noise(rng, h, w, cells)
        return np.asarray(color, np.float32) * (
            1.0 - contrast + contrast * 2.0 * n
        )[..., None]

    # back wall: disparity 0.12, bricks
    horizon = 0.42
    disp = np.full((h, w), 0.12, np.float32)
    brick_h = 0.035
    row = np.floor(vv / brick_h)
    bu = uu * 14.0 + 0.5 * (row % 2)
    mortar = (np.abs(vv / brick_h - row - 0.5) > 0.42) | (
        np.abs(bu - np.floor(bu) - 0.5) > 0.46
    )
    rgb = tex((0.55, 0.32, 0.22), 24, 0.35)
    rgb[mortar] = 0.7 * np.float32([0.75, 0.74, 0.70])

    # far opening in the back wall: disparity ~0 (the 900:1 range)
    ox0, ox1 = 0.56 + 0.06 * rng.random(), 0.80 + 0.04 * rng.random()
    oy0, oy1 = 0.55, 0.86
    opening = (uu > ox0) & (uu < ox1) & (vv > oy0) & (vv < oy1)
    sky = tex((0.35, 0.55, 0.85), 6, 0.25)
    hills = vv < oy0 + 0.08 + 0.05 * _value_noise(rng, h, w, 3, 2)
    far = np.where(hills[..., None], tex((0.22, 0.40, 0.18), 40, 0.4), sky)
    rgb[opening] = far[opening]
    disp[opening] = np.where(hills, 0.02, _FAR_DISP)[opening]

    # slanted left wall: disparity affine in u (a plane), 0.12 -> 0.5
    lw = 0.16
    left = uu < lw
    disp[left] = (0.5 - (0.5 - 0.12) * uu / lw)[left]
    rgb[left] = tex((0.42, 0.45, 0.52), 10, 0.4)[left]

    # floor: disparity affine in v (a ground plane), 0.12 at the horizon
    # to 0.9 at the bottom row; checker texture
    floor = vv < horizon
    fd = 0.12 + (0.9 - 0.12) * (horizon - vv) / horizon
    disp[floor] = fd[floor]
    # checker in floor coordinates: u spreads with depth, v by 1/disp
    cu = (uu - 0.5) * fd * 40.0
    cv = 6.0 / np.maximum(fd, 1e-3)
    check = ((np.floor(cu) + np.floor(cv)) % 2).astype(np.float32)
    floor_rgb = tex((0.62, 0.55, 0.40), 30, 0.3) * (
        0.75 + 0.25 * check
    )[..., None]
    rgb[floor] = floor_rgb[floor]

    # boxes standing on the floor: constant disparity = the floor's at
    # their base row (sharp steps against wall and floor)
    for i in range(5):
        cx = 0.12 + 0.76 * (i + rng.random()) / 5.0
        bw = 0.05 + 0.07 * rng.random()
        base = 0.06 + 0.26 * rng.random()
        top = base + 0.10 + 0.25 * rng.random()
        box = (np.abs(uu - cx) < bw / 2) & (vv > base) & (vv < top)
        bdisp = 0.12 + (0.9 - 0.12) * (horizon - base) / horizon
        disp[box] = bdisp
        col = rng.uniform(0.15, 0.85, 3)
        rgb[box] = tex(col, 16 + 8 * i, 0.45)[box]

    # thin structures: vertical poles a few pixels wide and a rail
    for i in range(3):
        px = 0.2 + 0.6 * rng.random()
        pw = (3.0 + 2.0 * rng.random()) / FLAGSHIP_W
        pdisp = 0.35 + 0.15 * i
        # a pole stands on the floor row whose disparity matches its own
        v_base = horizon * (1.0 - (pdisp - 0.12) / (0.9 - 0.12))
        pole = (np.abs(uu - px) < pw) & (vv > v_base)
        disp[pole] = pdisp
        rgb[pole] = np.float32([0.9, 0.88, 0.8]) * (0.4 + 0.3 * i)
    rail = (np.abs(vv - 0.33) < 1.5 / FLAGSHIP_H) & (uu > 0.25) & (uu < 0.7)
    disp[rail] = 0.6
    rgb[rail] = np.float32([0.1, 0.1, 0.12])

    rgb = np.clip(rgb, 0.0, 1.0).astype(np.float32)
    disp = np.clip(_soften(disp, _SOFTEN * w // FLAGSHIP_W), 0.0, 1.0)
    return rgb, disp.astype(np.float32)


def flagship_projector(seed: int = 0, scale: int = 1, position=(0, 0, 0)):
    """The flagship scene as a single-layer Projector."""
    from ..models.projector import projector_from_arrays

    s = flagship_scene(seed, scale)
    return projector_from_arrays(
        s.rgb, s.disp, focal_px=s.focal_px, invz_min=s.invz_min,
        invz_max=s.invz_max, baseline=s.baseline, position=position,
    )


def flagship_orbit_center(projector) -> np.ndarray:
    """The demo's orbit center: the convergence depth on the principal
    ray (invd = 0.045, reference LifLoader.ts:589-666)."""
    from ..models.api import orbit_center_from_stereo_data

    return orbit_center_from_stereo_data(
        projector, {"invd": INVD}, float(projector.baseline)
    )
