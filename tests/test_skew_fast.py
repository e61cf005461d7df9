"""Skewed-frustum support on the fast march path: sk1/sk2 fold into a
constant source pre-shift for unrotated views, so skewed golden renders pass
through render_fast_view instead of raising."""

import numpy as np
import pytest

from lif_tpu import Camera, projector_from_arrays
from lif_tpu.models.renderer import render_fast_view, render_mono_view


def _psnr(a, b, sl=np.s_[8:-8, 12:-12]):
    a, b = np.asarray(a), np.asarray(b)
    mse = np.mean((a[sl][..., :3] - b[sl][..., :3]) ** 2)
    return 10 * np.log10(1.0 / max(float(mse), 1e-12))


def _scene(rng, h=96, w=128):
    rgb = rng.random((h, w, 3), dtype=np.float32)
    k = np.ones(5, np.float32) / 5
    for c in range(3):
        rgb[..., c] = np.apply_along_axis(
            lambda r: np.convolve(r, k, mode="same"), 1, rgb[..., c]
        )
    disp = (
        0.5
        + 0.3
        * np.sin(np.arange(w) / 17)[None, :]
        * np.cos(np.arange(h) / 13)[:, None]
    ).astype(np.float32)
    return rgb, disp


def test_skewed_projector_and_camera(rng):
    """Both-sided skew: the fast path matches the skew-aware exact march
    (the constant-shift fold is exact under snap planes)."""
    h, w = 96, 128
    rgb, disp = _scene(rng, h, w)
    proj = projector_from_arrays(
        rgb, disp, focal_px=0.78 * w, invz_min=2.0, invz_max=0.1,
        baseline=1.0, skew=(0.03, -0.02),
    )
    cam = Camera.create(
        w, h, focal_px=0.78 * w, position=[0.05, 0.0, 0.0],
        skew=(0.01, 0.005),
    )
    ref = render_mono_view(proj, cam, mask_mode="none", num_steps=320)
    fast = render_fast_view(proj, cam)
    p = _psnr(fast, ref)
    assert p > 45.0, f"skewed fast path only {p:.1f} dB vs the march"
    assert float(np.mean(np.abs(
        np.asarray(fast)[..., 3] - np.asarray(ref)[..., 3]
    ))) < 1e-3


def test_camera_skew_only_stereo_display_case(rng):
    """sk2-only (the stereo-display asymmetric-frustum workload,
    RaycastPlane.ts:719-723)."""
    h, w = 96, 128
    rgb, disp = _scene(rng, h, w)
    proj = projector_from_arrays(
        rgb, disp, focal_px=0.78 * w, invz_min=2.0, invz_max=0.1,
        baseline=1.0,
    )
    cam = Camera.create(
        w, h, focal_px=0.78 * w, position=[-0.04, 0.0, 0.0],
        skew=(0.025, 0.0),
    )
    ref = render_mono_view(proj, cam, mask_mode="none", num_steps=320)
    fast = render_fast_view(proj, cam)
    p = _psnr(fast, ref)
    assert p > 45.0, f"sk2-only fast path only {p:.1f} dB vs the march"


def test_skew_with_rotation_renders(rng):
    """Rotated + skewed: S(sk1)/S(sk2) ride the two-phase
    tier's FSKR sandwiches (reference folds skew into every pose,
    rayCastMonoLDI.glsl:316-332) — the former ValueError is gone."""
    h, w = 64, 96
    rgb, disp = _scene(rng, h, w)
    proj = projector_from_arrays(
        rgb, disp, focal_px=0.78 * w, invz_min=2.0, invz_max=0.1,
        baseline=1.0, skew=(0.02, 0.0),
    )
    ry = np.array(
        [[np.cos(0.05), 0, np.sin(0.05)], [0, 1, 0],
         [-np.sin(0.05), 0, np.cos(0.05)]]
    )
    cam = Camera.create(
        w, h, focal_px=0.78 * w, position=[0.02, 0.0, 0.0], rotation=ry,
        skew=(0.0, 0.01),
    )
    ref = render_mono_view(proj, cam, mask_mode="none", num_steps=320)
    fast = render_fast_view(proj, cam)
    p = _psnr(fast, ref)
    assert p > 40.0, f"rotated+skewed fast path only {p:.1f} dB"


def test_skewed_batch_lateral_march(rng):
    """Skewed pose BATCH through render_fast_batch (the batch entry
    point once raised outright on any skew): the lateral
    snap-march tier folds the per-layer constant shift exactly like the
    single-view path."""
    from lif_tpu.models.renderer import render_fast_batch

    h, w = 96, 128
    rgb, disp = _scene(rng, h, w)
    proj = projector_from_arrays(
        rgb, disp, focal_px=0.78 * w, invz_min=2.0, invz_max=0.1,
        baseline=1.0, skew=(0.03, -0.02),
    )
    cams = [
        Camera.create(
            w, h, focal_px=0.78 * w, position=[0.02 * i - 0.03, 0.0, 0.0],
            skew=(0.01, 0.005),
        )
        for i in range(4)
    ]
    out, tiers = render_fast_batch(proj, cams, return_tiers=True)
    assert list(tiers) == ["march"]
    for i, cam in enumerate(cams):
        ref = render_mono_view(proj, cam, mask_mode="none", num_steps=320)
        p = _psnr(out[i], ref)
        assert p > 45.0, f"skewed batch pose {i} only {p:.1f} dB"


def test_skewed_batch_rotated_tier(rng):
    """Skewed ROTATED pose batch: routes the two-phase tier with the
    FSKR skew fold; golden per pose vs the skew-aware exact march."""
    from lif_tpu.models.renderer import render_fast_batch

    h, w = 96, 128
    rgb, disp = _scene(rng, h, w)
    proj = projector_from_arrays(
        rgb, disp, focal_px=0.78 * w, invz_min=2.0, invz_max=0.1,
        baseline=1.0, skew=(0.02, 0.01),
    )

    def ry(t):
        return np.array(
            [[np.cos(t), 0, np.sin(t)], [0, 1, 0],
             [-np.sin(t), 0, np.cos(t)]]
        )

    cams = [
        Camera.create(
            w, h, focal_px=0.78 * w, position=[0.03, 0.0, 0.01],
            rotation=ry(0.04 * (i - 1)), skew=(-0.005, 0.0),
        )
        for i in range(3)
    ]
    out, tiers = render_fast_batch(proj, cams, return_tiers=True)
    assert list(tiers) == ["rotated"]
    for i, cam in enumerate(cams):
        ref = render_mono_view(proj, cam, mask_mode="none", num_steps=320)
        p = _psnr(out[i], ref)
        assert p > 40.0, f"skewed rotated batch pose {i} only {p:.1f} dB"


def test_skewed_stereo_rotated_head(rng):
    """Skewed stereo at a ROTATED head pose (no longer a
    general-pose skew ValueError): per-eye
    source skew + camera skew through the two-phase tier, vs the exact
    two-view kernel."""
    from lif_tpu import render_stereo_fast
    from lif_tpu.models.renderer import render_stereo_view

    h, w = 96, 128
    rgb, disp = _scene(rng, h, w)
    rgb2 = np.roll(rgb, 3, axis=1)

    def proj(r, x, sk):
        return projector_from_arrays(
            r, disp, focal_px=0.78 * w, invz_min=2.0, invz_max=0.1,
            baseline=1.0, position=(x, 0.0, 0.0), skew=sk,
        )

    left = proj(rgb, -0.03, (0.015, 0.0))
    right = proj(rgb2, 0.03, (-0.015, 0.0))
    t = 0.05
    rot = np.array(
        [[np.cos(t), 0, np.sin(t)], [0, 1, 0], [-np.sin(t), 0, np.cos(t)]]
    )
    cam = Camera.create(
        w, h, focal_px=0.78 * w, position=[0.01, 0.0, 0.0], rotation=rot,
        skew=(0.005, 0.0),
    )
    exact = render_stereo_view(left, right, cam, num_steps=320)
    fast = render_stereo_fast(left, right, cam)
    p = _psnr(fast, exact)
    assert p > 40.0, f"skewed rotated-head stereo only {p:.1f} dB"


def test_skewed_stereo_fast(rng):
    """Skewed stereo through the fast two-view path (the stereo-display
    workload: per-eye source skew, shared camera skew) vs the exact
    skew-aware stereo kernel."""
    from lif_tpu import projector_from_arrays, render_stereo_fast
    from lif_tpu.models.renderer import render_stereo_view

    h, w = 96, 128
    rgb, disp = _scene(rng, h, w)
    rgb2 = np.roll(rgb, 3, axis=1)

    def proj(r, x, sk):
        return projector_from_arrays(
            r, disp, focal_px=0.78 * w, invz_min=2.0, invz_max=0.1,
            baseline=1.0, position=(x, 0.0, 0.0), skew=sk,
        )

    left = proj(rgb, -0.03, (0.015, 0.0))
    right = proj(rgb2, 0.03, (-0.015, 0.0))
    cam = Camera.create(
        w, h, focal_px=0.78 * w, position=[0.01, 0.0, 0.0],
        skew=(0.005, 0.0),
    )
    exact = render_stereo_view(left, right, cam, num_steps=160)
    fast = render_stereo_fast(left, right, cam, num_planes=160)
    p = _psnr(fast, exact)
    assert p > 35.0, f"skewed stereo fast only {p:.1f} dB"


def test_skewed_stereo_fast_scaled_tier(rng):
    """Skewed stereo with a march-INELIGIBLE layer (f1 != f2 zoom): the
    layer routes the scaled tier, which must still apply the per-eye
    frustum fold (dx as a constant warp shift, dy via the kernel's
    dy_user) — a dropped fold misaligns the layer by f1*dsk pixels
    against the exact kernel."""
    from lif_tpu import projector_from_arrays, render_stereo_fast
    from lif_tpu.models.renderer import render_stereo_view

    h, w = 96, 128
    rgb, disp = _scene(rng, h, w)
    rgb2 = np.roll(rgb, 3, axis=1)

    def proj(r, x, sk):
        return projector_from_arrays(
            r, disp, focal_px=0.78 * w, invz_min=2.0, invz_max=0.1,
            baseline=1.0, position=(x, 0.0, 0.0), skew=sk,
        )

    left = proj(rgb, -0.03, (0.015, 0.008))
    right = proj(rgb2, 0.03, (-0.015, 0.0))
    # camera focal != projector focal -> _march_eligible is False for
    # every layer; lateral poses + skew exercise the scaled-tier fold
    cam = Camera.create(
        w, h, focal_px=0.9 * w, position=[0.01, 0.0, 0.0],
        skew=(0.005, 0.0),
    )
    exact = render_stereo_view(left, right, cam, num_steps=160)
    fast = render_stereo_fast(left, right, cam, num_planes=160)
    p = _psnr(fast, exact)
    # bound: the 160-step oracle march discretization (same class as
    # test_skewed_stereo_fast) plus the scaled tier's off-snap sampling
    assert p > 33.0, f"skewed scaled-tier stereo only {p:.1f} dB"
