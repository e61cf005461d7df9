"""Tests for the gather-free matmul fast sweep renderer."""

import numpy as np
import pytest

import jax.numpy as jnp

from lif_tpu import Camera, projector_from_arrays, render
from lif_tpu.models.renderer import render_fast_view
from lif_tpu.ops import sweep_fast
from . import reference_renderer as ref
from .scenes import make_layer, layers_to_arrays, smooth_noise


def _run(layer, c1, w, h, f2=None, planes=80, **kw):
    arrs = layers_to_arrays([layer])
    f2 = f2 or 0.78 * w
    return np.asarray(sweep_fast.render_sweep_aligned(
        jnp.asarray(arrs["rgb"][0]), jnp.asarray(arrs["disp"][0]),
        jnp.asarray(arrs["mask"][0]),
        2.0, 0.2, jnp.asarray(c1, jnp.float32), jnp.float32(f2),
        jnp.zeros(4, jnp.float32), out_w=w, out_h=h,
        focal1=jnp.float32(0.78 * w), num_planes=planes, **kw,
    ))


def test_matches_march_translation(rng):
    h, w = 48, 64
    layer = make_layer(rng, h, w)
    for c1 in ([0.2, 0, 0], [0, 0.2, 0], [0, 0, 0.2], [0.15, -0.05, 0.1]):
        golden = ref.render_mono_reference(
            [layer], (0, 0), c1, np.eye(3), 0.78 * w, (0, 0), w, h
        )
        img = _run(layer, c1, w, h)
        assert ref.psnr(golden, img) > 40.0, c1


def test_matches_march_zoom(rng):
    """Mismatched target focal exercises the f1/f2 scale term."""
    h, w = 48, 64
    layer = make_layer(rng, h, w)
    golden = ref.render_mono_reference(
        [layer], (0, 0), [0.1, 0, 0], np.eye(3), 0.6 * w, (0, 0), w, h
    )
    img = _run(layer, [0.1, 0, 0], w, h, f2=0.6 * w)
    assert ref.psnr(golden, img) > 40.0


def test_identity_passthrough(rng):
    h, w = 48, 64
    layer = make_layer(rng, h, w)
    img = _run(layer, [0, 0, 0], w, h)
    expected = np.asarray(ref.linear_to_srgb(layer["rgb"]))
    assert np.abs(img[8:-8, 8:-8, :3] - expected[8:-8, 8:-8]).max() < 2e-2


def test_render_fast_view_api(rng):
    h, w = 32, 48
    proj = projector_from_arrays(
        rng.random((h, w, 3)).astype(np.float32),
        smooth_noise(rng, h, w).astype(np.float32),
        focal_px=0.78 * w, invz_min=2.0, invz_max=0.2, baseline=1.0,
    )
    cam = Camera.create(w, h, focal_px=0.78 * w, position=(0.1, 0, 0.05))
    img_fast = np.asarray(render(proj, cam, mode="fast"))
    img_march = np.asarray(render(proj, cam, mode="raycast"))
    assert img_fast.shape == (h, w, 4)
    # bound: the oracle is the production 40-STEP march (reference
    # default), whose own discretization error dominates at this scale
    assert ref.psnr(img_march, img_fast) > 35.0

    # rotated camera goes through the two-phase rotated path
    from lif_tpu.core.pose import orbit_pose

    pos, rot = orbit_pose([0, 0, -1], 1.0, 0.15)
    cam_rot = Camera.create(w, h, focal_px=0.78 * w, position=pos, rotation=rot)
    img_rot = np.asarray(render_fast_view(proj, cam_rot))
    img_rot_march = np.asarray(render(proj, cam_rot, mode="raycast"))
    # bound: same 40-step oracle discretization (rotated pose)
    assert ref.psnr(img_rot_march, img_rot) > 35.0


def test_fast_view_ldi_layers(rng):
    h, w = 32, 48
    extra = dict(
        rgb=rng.random((h, w, 3)).astype(np.float32),
        disp=smooth_noise(rng, h, w).astype(np.float32),
        mask=(smooth_noise(rng, h, w) > 0.4).astype(np.float32),
        focal_px=0.78 * w, invz_min=1.0, invz_max=0.1,
    )
    proj = projector_from_arrays(
        rng.random((h, w, 3)).astype(np.float32),
        smooth_noise(rng, h, w).astype(np.float32),
        mask=(smooth_noise(rng, h, w) > 0.4).astype(np.float32),
        focal_px=0.78 * w, invz_min=2.0, invz_max=0.9, baseline=1.0,
        extra_layers=[extra],
    )
    cam = Camera.create(w, h, focal_px=0.78 * w, position=(0.05, 0.02, 0))
    img = np.asarray(render(proj, cam, mode="fast"))
    assert img.shape == (h, w, 4) and np.isfinite(img).all()
    assert (img[..., 3] > 0.2).mean() > 0.3


def test_rotated_matches_march(rng):
    """The two-phase rotated path (aligned depth solve + rotation
    homography + exact color gather) against the float64 march."""
    from lif_tpu.core import pose as _pose

    h, w = 48, 64
    layer = make_layer(rng, h, w)
    arrs = layers_to_arrays([layer])
    cam_pos, cam_rot = _pose.orbit_pose([0, 0, -0.8], 0.8, theta=0.12, phi=0.05)
    c1, rot1 = _pose.relative_view_pose(np.zeros(3), np.eye(3), cam_pos, cam_rot)
    golden = ref.render_mono_reference(
        [layer], (0, 0), c1, rot1, 0.78 * w, (0, 0), w, h
    )
    img = np.asarray(sweep_fast.render_rotated(
        jnp.asarray(arrs["rgb"][0]), jnp.asarray(arrs["disp"][0]),
        jnp.asarray(arrs["mask"][0]),
        2.0, 0.2, jnp.asarray(c1, jnp.float32), jnp.asarray(rot1, jnp.float32),
        jnp.float32(0.78 * w), jnp.zeros(4, jnp.float32), out_w=w, out_h=h,
        focal1=jnp.float32(0.78 * w), num_planes=80,
    ))
    assert ref.psnr(golden, img) > 40.0


def test_solve_depth_aligned(rng):
    """Flat disparity: the solved invZ* equals the decoded surface invz."""
    h, w = 32, 48
    disp = jnp.full((h, w), 0.25, jnp.float32)
    izmin, izmax = 2.0, 0.2
    expected = izmax + (izmin - izmax) * 0.25
    invz_map = np.asarray(sweep_fast.solve_depth_aligned(
        disp, izmin, izmax, jnp.asarray([0.1, 0, 0], jnp.float32),
        jnp.float32(0.78 * w), out_w=w, out_h=h, num_planes=64,
    ))
    interior = invz_map[4:-4, 4:-4]
    np.testing.assert_allclose(interior, expected, rtol=2e-3)


def test_sweep_fallback_warns(rng):
    """A layer demoted to the approximate plane sweep must WARN (a
    silent 15 dB drop would hide from library callers). The scene:
    a rotated pose too large for the march tiers at this tiny scale, so
    the matched-focal layer falls back to the sweep."""
    import warnings

    from lif_tpu.models.renderer import (
        TierFallbackWarning,
        render_fast_batch,
    )
    from lif_tpu.core.pose import orbit_pose

    h, w = 32, 48
    proj = projector_from_arrays(
        rng.random((h, w, 3)).astype(np.float32),
        smooth_noise(rng, h, w).astype(np.float32),
        focal_px=0.78 * w, invz_min=2.0, invz_max=0.2, baseline=1.0,
    )
    pos, rot = orbit_pose([0, 0, -1], 1.0, 0.15)
    cam = Camera.create(w, h, focal_px=0.78 * w, position=pos,
                        rotation=rot)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        _, tiers = render_fast_batch(proj, [cam], return_tiers=True)
    fired = [r for r in rec if issubclass(r.category, TierFallbackWarning)]
    if "sweep" in tiers:
        assert fired, "sweep demotion must warn"
        assert "plane-sweep" in str(fired[0].message)
    else:  # planner budgets widened enough that no layer fell back
        assert not fired
