"""Pitch-family (elevation) poses through the transposed target march.

The demo's spherical orbit controls have an elevation axis (reference
index.html:1271-1313, phi) whose poses fail plan_target's yaw gate —
source x positions depend on the target row. renderer.render_fast_batch
now maps them onto the yaw family by an x<->y transpose of source and
target (conjugating every pose by the swap) and renders the single-phase
target-ray march there, instead of dropping to the two-phase rotated
tier. These tests pin the ROUTING (the transposed call must report the
'target' tier) and march-class fidelity on the flagship scene, plus the
fallback for poses with both yaw and pitch (neither orientation passes
the gate).

Scale 2 (640x400) like test_flagship_orbit: the transposed output width
is the 128-padded HEIGHT (400 -> 512), exercising the symmetric-pad
slice.
"""

import numpy as np
import pytest


@pytest.fixture(scope="module")
def scene():
    from lif_tpu.io.synthetic import flagship_orbit_center, flagship_projector

    proj = flagship_projector(seed=0, scale=2)
    return proj, flagship_orbit_center(proj)


def _elevation_cams(scene, phis_deg):
    from lif_tpu import Camera, orbit_pose

    proj, center = scene
    focal = float(proj.focal[0])
    return [
        Camera.create(proj.width, proj.height, focal_px=focal,
                      position=p, rotation=r)
        for p, r in (
            orbit_pose(center, 1.0, theta=0.0,
                       phi=np.deg2rad(t))
            for t in phis_deg
        )
    ]


def test_elevation_orbit_routes_target_tier_at_march_fidelity(scene):
    from lif_tpu import render
    from lif_tpu.models.renderer import render_fast_batch

    proj = scene[0]
    cams = _elevation_cams(scene, (12.0, 5.0))
    out, tiers = render_fast_batch(proj, cams, return_tiers=True)
    assert list(tiers) == ["target"], (
        f"elevation orbit routed {list(tiers)} — pitch-family poses "
        "must ride the transposed single-phase march"
    )
    out = np.asarray(out)
    # march-class fidelity at the edge pose (the yaw flagship golden
    # allows 38 at this scale; elevation measures 43.2 dB on CPU at
    # scale 2 and 43.6 at full scale — hold the full 40 dB gate here)
    ref = np.asarray(render(proj, cams[0], mode="raycast", num_steps=640))
    mse = np.mean((out[0][..., :3] - ref[..., :3]) ** 2)
    p = 10 * np.log10(1.0 / max(float(mse), 1e-12))
    assert p >= 40.0, f"edge elevation pose only {p:.2f} dB vs converged"


def test_combined_yaw_pitch_falls_back_to_rotated(scene):
    """A pose rotated about BOTH axes fails the yaw gate in both
    orientations; the tier cascade must keep the two-phase fallback."""
    from lif_tpu import Camera, orbit_pose
    from lif_tpu.models.renderer import render_fast_batch

    proj, center = scene
    focal = float(proj.focal[0])
    # 6 deg on each axis: inside the two-phase planner's window budget
    # (9/9 deg overflows it and drops to the sweep — also a legal, but
    # different, fallback)
    p, r = orbit_pose(center, 1.0, theta=np.deg2rad(6.0),
                      phi=np.deg2rad(6.0))
    cam = Camera.create(proj.width, proj.height, focal_px=focal,
                        position=p, rotation=r)
    out, tiers = render_fast_batch(proj, [cam], return_tiers=True)
    assert list(tiers) == ["rotated"]
    a = np.asarray(out)
    assert np.isfinite(a).all()
    assert a[..., 3].max() > 0.5
    # the two-phase tier's fidelity on the flagship scene: 35.3 dB on CPU
    # here (chip_smoke.py holds the card to the same bound)
    from lif_tpu import render

    ref = np.asarray(render(proj, cam, mode="raycast", num_steps=640))
    mse = np.mean((a[0][..., :3] - ref[..., :3]) ** 2)
    p = 10 * np.log10(1.0 / max(float(mse), 1e-12))
    assert p >= 33.0, f"combined yaw+pitch pose only {p:.2f} dB"
