"""Golden tests for the two-phase rotated march.

Oracle: ops/raycast at high step count (itself golden vs the float64
GLSL transliteration). The two-phase path must reproduce rotated,
rotated+translated, pure-rotation, and zoom poses at march-class
fidelity — pose families that the matmul-sweep path rendered at
~35 dB.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from lif_tpu.ops import rotated_march
from tests.test_sweep_march import _psnr, _scene


def _roty(deg):
    t = np.deg2rad(deg)
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float64)


def _rotx(deg):
    t = np.deg2rad(deg)
    c, s = np.cos(t), np.sin(t)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float64)


def _march_rot(rgb, disp, mask, izmin, izmax, f1, c1, rot1, w, h,
               steps=480, f2=None):
    from lif_tpu.ops import raycast

    f2 = f1 if f2 is None else f2
    return np.asarray(
        raycast.render_mono(
            jnp.asarray(rgb[None]), jnp.asarray(disp[None]),
            jnp.asarray(mask[None]),
            jnp.asarray([[w, h]], jnp.float32),
            jnp.asarray([izmin]), jnp.asarray([izmax]),
            jnp.asarray([f1]), jnp.zeros(2),
            jnp.asarray(c1, jnp.float32), jnp.asarray(rot1, jnp.float32),
            jnp.float32(f2), jnp.zeros(2), jnp.zeros(4),
            out_w=w, out_h=h, num_layers=1, num_steps=steps,
            mask_mode="none",
        )
    )


def _two_phase(rng, c1, rot1, fr=1.0, h=96, w=128, refine=2):
    rgb, disp, mask = _scene(rng, h=h, w=w)
    izmin, izmax = 2.0, 0.1
    f1 = 0.78 * w
    f2 = f1 / fr
    plan, wi, hi, aligned, grids, k, skip = rotated_march.plan_rotated(
        w, h, w, h, f1, f2, [rot1], [c1], izmin, izmax, step_px=0.75
    )
    out = np.asarray(
        rotated_march.render_rotated_march_batch(
            rgb, disp, mask, izmin, izmax, f1,
            np.asarray(c1, np.float32)[None],
            np.asarray(rot1, np.float32)[None],
            np.asarray(aligned, np.float32),
            f2,
            jnp.zeros((1, max(k, 1)), jnp.float32) if skip
            else jnp.asarray(grids),
            jnp.zeros(4), plan, max(k, 1), w, h, wi, hi,
            mask_mode="none", refine=refine, skip_phase_a=skip,
        )
    )[0]
    ref = _march_rot(rgb, disp, mask, izmin, izmax, f1, c1, rot1, w, h,
                     f2=f2)
    sl = np.s_[10:-10, 10:-10]
    return _psnr(out[sl], ref[sl]), skip


def _rotz(deg):
    t = np.deg2rad(deg)
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float64)


@pytest.mark.parametrize(
    "c1,rot,fr,name,floor",
    [
        # floors: the lattice-seeded bracket march solves the
        # exact crossing per final ray, so the tier is march-class for
        # the FULL rotation group (measured 59-78 dB vs the 480-step
        # oracle; the old interpolating phase B capped at ~37 dB)
        ([0.04, 0.0, 0.0], _roty(4.0), 1.0, "yaw+lateral", 50.0),
        ([0.03, 0.01, 0.02], _roty(3.0) @ _rotx(2.0), 1.0, "general", 50.0),
        ([0.0, 0.0, 0.0], _roty(6.0), 1.0, "pure-rotation", 50.0),
        ([0.0, 0.0, 0.0], np.eye(3), 1.1, "pure-zoom", 50.0),
        ([0.03, 0.0, 0.0], _roty(3.0), 1.06, "rot+zoom", 50.0),
        ([0.05, 0.0, 0.0], _rotz(10.0), 1.0, "roll+lateral", 50.0),
        (
            [0.02, 0.01, 0.0],
            _rotz(12.0) @ _roty(8.0) @ _rotx(5.0),
            1.0,
            "roll+yaw+pitch",
            50.0,
        ),
    ],
)
def test_two_phase_matches_converged_march(rng, c1, rot, fr, name, floor):
    p, skip = _two_phase(rng, c1, rot, fr=fr)
    assert p > floor, f"{name}: two-phase only {p:.1f} dB (skipA={skip})"


def test_pure_rotation_skips_phase_a(rng):
    _, skip = _two_phase(rng, [0.0, 0.0, 0.0], _roty(5.0))
    assert skip


def test_batch_matches_per_pose(rng):
    """Batched two-phase render equals per-pose calls."""
    h, w = 96, 128
    rgb, disp, mask = _scene(rng, h=h, w=w)
    izmin, izmax = 2.0, 0.1
    f1 = 0.78 * w
    rots = [_roty(d) for d in (-3.0, 0.0, 3.0)]
    c1s = [[0.03, 0.0, 0.01], [0.04, 0.01, 0.0], [0.02, 0.0, 0.02]]
    plan, wi, hi, aligned, grids, k, skip = rotated_march.plan_rotated(
        w, h, w, h, f1, f1, rots, c1s, izmin, izmax
    )
    assert not skip
    batch = np.asarray(
        rotated_march.render_rotated_march_batch(
            rgb, disp, mask, izmin, izmax, f1,
            np.asarray(c1s, np.float32), np.asarray(rots, np.float32),
            np.asarray(aligned, np.float32), f1, jnp.asarray(grids),
            jnp.zeros(4), plan, k, w, h, wi, hi, mask_mode="none",
        )
    )
    for i in range(3):
        single = np.asarray(
            rotated_march.render_rotated_march_batch(
                rgb, disp, mask, izmin, izmax, f1,
                np.asarray(c1s[i], np.float32)[None],
                np.asarray(rots[i], np.float32)[None],
                np.asarray(aligned[i], np.float32)[None], f1,
                jnp.asarray(grids[i])[None],
                jnp.zeros(4), plan, k, w, h, wi, hi, mask_mode="none",
            )
        )[0]
        assert np.allclose(batch[i], single, atol=1e-5)


def test_odd_width_rotated_pose_drops_pad(rng):
    """Odd output width (wpad > 0) + a rotated pose: the batch entry
    plans the band tiers at the padded width first, then drops the pad
    because the rotated tier ignores it — the rotated/target setups are
    reused as-is while only band-tier layers replan (renderer.py wpad
    drop). Routed tier must be non-sweep and golden vs the exact march
    at the SAME odd-width camera."""
    from lif_tpu import Camera, projector_from_arrays
    from lif_tpu.models.renderer import render_fast_batch, render_mono_view

    h, w = 96, 127  # w % 8 == 7 -> wpad = 1 before the drop
    rgb, disp, mask = _scene(rng, h=h, w=w)
    proj = projector_from_arrays(
        rgb, disp, focal_px=0.78 * w, invz_min=2.0, invz_max=0.1,
        baseline=1.0,
    )
    cam = Camera.create(
        w, h, focal_px=0.78 * w, position=[0.03, 0.0, 0.0],
        rotation=_roty(3.0),
    )
    out, tiers = render_fast_batch(proj, [cam], return_tiers=True)
    out = np.asarray(out)[0]
    assert out.shape == (h, w, 4)
    assert tiers[0] in ("rotated", "target"), tiers
    ref = np.asarray(render_mono_view(proj, cam, mask_mode="none",
                                      num_steps=320))
    sl = np.s_[10:-10, 10:-10]
    p = _psnr(out[sl], ref[sl])
    assert p > 38.0, f"odd-width rotated pose only {p:.1f} dB"
