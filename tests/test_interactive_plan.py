"""Interactive-pose planning: a NOVEL camera
inside a previously planned pose neighborhood must not pay the full
target-tier host planning cost — the plan is keyed on BUCKETED window
extents (ops/sweep_target.bucket_extents), so nearby poses share the
compiled kernel and its window tables by construction, and only the
sub-ms extent measurement plus the per-pose scalar/ladder packs run.

Reference budget: ~0.12 ms/projector/frame of pose-update cost
(ROTATION-MATRIX-API.md:229-241). The wall-clock assertion here is
deliberately generous (CI machines vary); the structural asserts carry
the guarantee.
"""

import time

import numpy as np
import pytest

from lif_tpu import Camera, projector_from_arrays
from lif_tpu.config import DEFAULT_CONFIG
from lif_tpu.models import renderer as R
from lif_tpu.ops import sweep_target as ST


def _psnr(a, b, sl=np.s_[8:-8, 12:-12]):
    a, b = np.asarray(a), np.asarray(b)
    mse = np.mean((a[sl][..., :3] - b[sl][..., :3]) ** 2)
    return 10 * np.log10(1.0 / max(float(mse), 1e-12))


def _yaw(t):
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


@pytest.fixture()
def scene(rng):
    h, w = 96, 128
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
    proj = projector_from_arrays(
        rgb, disp, focal_px=0.78 * w, invz_min=2.0, invz_max=0.1,
        baseline=1.0,
    )
    return proj, h, w


def _plan_one(proj, cam, f2, w, h):
    """Run the target-tier planner exactly as render_fast_batch would
    for one pose; returns (mode, static, dyn)."""
    from lif_tpu.core.pose import relative_view_pose

    pos, rot = relative_view_pose(
        np.asarray(proj.position, np.float64),
        np.asarray(proj.rotation, np.float64),
        np.asarray(cam.position, np.float64),
        np.asarray(cam.rotation, np.float64),
    )
    lay = R._prepared_fast(proj, DEFAULT_CONFIG.march_planes)["layers"][0]
    return R._plan_march_tier(
        lay, f2, w, w, h, pos[None], [rot], [pos], True,
        DEFAULT_CONFIG, None,
    )


def test_novel_pose_reuses_neighborhood_plan(scene):
    """A nearby-but-new pose (different exact-batch key) must hit the
    bucketed-extent cache: the same TargetPlan object (a jit static), so
    no plan_from_extents rerun and no recompile."""
    proj, h, w = scene
    f2 = 0.78 * w
    cam_a = Camera.create(
        w, h, focal_px=f2, position=[0.03, 0.0, 0.0],
        rotation=_yaw(np.deg2rad(3.0)),
    )
    cam_b = Camera.create(
        w, h, focal_px=f2, position=[0.031, 0.0, 0.0],
        rotation=_yaw(np.deg2rad(3.2)),
    )
    R._TARGET_PLAN_CACHE.clear()
    R._TARGET_NEIGHBORHOOD_CACHE.clear()
    mode_a, static_a, dyn_a = _plan_one(proj, cam_a, f2, w, h)
    assert mode_a == "target"
    assert len(R._TARGET_NEIGHBORHOOD_CACHE) == 1
    mode_b, static_b, dyn_b = _plan_one(proj, cam_b, f2, w, h)
    assert mode_b == "target"
    # the neighborhood entry was REUSED, not re-created
    assert len(R._TARGET_NEIGHBORHOOD_CACHE) == 1
    assert static_b[0] is static_a[0], "TargetPlan must be shared"
    assert set(dyn_b) == {"pose_sc", "grids"}


def test_novel_pose_plan_latency(scene):
    """Planning for an unseen pose inside a warmed neighborhood is
    host-cheap. The budget is loose for CI variance."""
    proj, h, w = scene
    f2 = 0.78 * w
    R._TARGET_PLAN_CACHE.clear()
    R._TARGET_NEIGHBORHOOD_CACHE.clear()
    _plan_one(
        proj,
        Camera.create(w, h, focal_px=f2, position=[0.03, 0.0, 0.0],
                      rotation=_yaw(np.deg2rad(3.0))),
        f2, w, h,
    )  # warm the neighborhood
    ts = []
    for i in range(5):
        cam = Camera.create(
            w, h, focal_px=f2, position=[0.03 + 1e-4 * (i + 1), 0.0, 0.0],
            rotation=_yaw(np.deg2rad(3.0 + 0.02 * (i + 1))),
        )
        t0 = time.perf_counter()
        mode, _, _ = _plan_one(proj, cam, f2, w, h)
        ts.append(time.perf_counter() - t0)
        assert mode == "target"
    med = sorted(ts)[len(ts) // 2]
    assert med < 0.025, f"novel-pose planning took {med * 1e3:.1f} ms"


def test_neighborhood_plan_is_faithful(scene):
    """Rendering through a neighborhood (bucketed, widened) plan matches
    the exact-extent plan's output: widening window extents must not
    change the math."""
    import jax.numpy as jnp

    from lif_tpu.models.renderer import render_fast_batch

    proj, h, w = scene
    f2 = 0.78 * w
    cams = [
        Camera.create(
            w, h, focal_px=f2, position=[0.02 + 0.002 * i, 0.0, 0.0],
            rotation=_yaw(np.deg2rad(2.0 + 0.5 * i)),
        )
        for i in range(3)
    ]
    R._TARGET_PLAN_CACHE.clear()
    R._TARGET_NEIGHBORHOOD_CACHE.clear()
    out, tiers = render_fast_batch(proj, cams, return_tiers=True)
    assert tiers == ("target",)
    from lif_tpu.models.renderer import render_mono_view

    ref = render_mono_view(proj, cams[1], mask_mode="none", num_steps=320)
    p = _psnr(np.asarray(out[1]), np.asarray(ref))
    assert p > 40.0, f"neighborhood-plan render degraded: {p:.1f} dB"
