"""Multi-device sharding tests on the virtual 8-device CPU mesh."""

import numpy as np
import pytest

import jax

from lif_tpu import Camera, projector_from_arrays, render_mono_view
from lif_tpu.parallel import sharding
from .scenes import smooth_noise


@pytest.fixture
def proj(rng):
    h, w = 32, 48
    return projector_from_arrays(
        rng.random((h, w, 3)).astype(np.float32),
        smooth_noise(rng, h, w).astype(np.float32),
        focal_px=0.78 * w,
        invz_min=2.0,
        invz_max=0.2,
        baseline=1.0,
        position=(0.05, 0.02, 0.0),
    )


def test_devices_available():
    assert len(jax.devices()) == 8


def test_tiled_render_matches_single_device(proj):
    cam = Camera.create(48, 32, focal_px=0.78 * 48, position=(0.1, 0, 0.05))
    mesh = sharding.make_mesh(("tile",))
    tiled = np.asarray(sharding.render_view_tiled(proj, cam, mesh))
    single = np.asarray(render_mono_view(proj, cam, mask_mode="none"))
    np.testing.assert_allclose(tiled, single, atol=1e-5)


def test_trajectory_sharded(proj):
    cam = Camera.create(48, 32, focal_px=0.78 * 48)
    f = 16
    positions = np.stack(
        [np.array([0.02 * i, 0.0, 0.01 * i]) for i in range(f)]
    )
    rotations = np.stack([np.eye(3)] * f)
    mesh = sharding.make_mesh(("frame",))
    out = np.asarray(
        sharding.render_trajectory_sharded(
            proj, positions, rotations, cam, mesh
        )
    )
    assert out.shape == (f, 32, 48, 4)
    assert np.isfinite(out).all()
    # frames must differ (the poses differ) and frame i must equal the
    # single-device render of that pose
    assert np.abs(out[0] - out[-1]).max() > 0.01
    cam5 = Camera.create(48, 32, focal_px=0.78 * 48, position=positions[5])
    single = np.asarray(render_mono_view(proj, cam5, mask_mode="none"))
    np.testing.assert_allclose(out[5], single, atol=1e-5)


def test_fused_projectors(rng):
    h, w = 32, 48
    projs = []
    for i in range(8):
        projs.append(
            projector_from_arrays(
                rng.random((h, w, 3)).astype(np.float32),
                smooth_noise(rng, h, w).astype(np.float32),
                focal_px=0.78 * w,
                invz_min=2.0,
                invz_max=0.2,
                baseline=1.0,
                position=(0.03 * i - 0.1, 0.0, 0.0),
            )
        )
    cam = Camera.create(48, 32, focal_px=0.78 * 48)
    mesh = sharding.make_mesh(("view",))
    fused = np.asarray(sharding.render_fused_projectors(projs, cam, mesh))
    assert fused.shape == (32, 48, 4)
    assert np.isfinite(fused).all()
    assert (fused[..., 3] > 0.5).mean() > 0.5

    # fusing 8 copies of the SAME projector must equal its solo render
    same = [projs[0]] * 8
    fused_same = np.asarray(sharding.render_fused_projectors(same, cam, mesh))
    single = np.asarray(render_mono_view(projs[0], cam, mask_mode="none"))
    np.testing.assert_allclose(fused_same, single, atol=1e-4)


def test_tile_and_view_mesh(rng):
    """Combined 4-projector x 2-tile mesh exercises a 2-D mesh layout."""
    mesh = sharding.make_mesh(("view", "tile"), shape=(4, 2))
    assert mesh.shape["view"] == 4 and mesh.shape["tile"] == 2


def test_fast_trajectory_sharded(rng):
    """DP-sharded PRODUCTION kernel: frames shard over the mesh, each
    device runs the batched first-crossing march; equals the unsharded
    render_fast_batch frame-for-frame."""
    from lif_tpu.models.renderer import render_fast_batch

    h, w = 32, 48
    proj = projector_from_arrays(
        rng.random((h, w, 3)).astype(np.float32),
        smooth_noise(rng, h, w).astype(np.float32),
        focal_px=0.78 * w, invz_min=2.0, invz_max=0.2, baseline=1.0,
    )
    cam = Camera.create(w, h, focal_px=0.78 * w)
    f = 16
    positions = np.stack([[0.005 * (i + 1), 0.0, 0.0] for i in range(f)])
    mesh = sharding.make_mesh(("frame",))
    out = np.asarray(
        sharding.render_fast_trajectory_sharded(proj, positions, cam, mesh)
    )
    assert out.shape == (f, h, w, 4)
    cams = [
        Camera.create(w, h, focal_px=0.78 * w, position=p)
        for p in positions
    ]
    ref = np.asarray(render_fast_batch(proj, cams, mask_mode="none"))
    np.testing.assert_allclose(out, ref, atol=2e-4)


def test_fast_trajectory_sharded_ldi(rng):
    """Multi-layer LDI trajectories shard on the fast path (not
    only single-layer ones): the shard body
    composites all layers front-to-back and equals the unsharded
    render_fast_batch frame-for-frame on the virtual mesh."""
    from lif_tpu.models.renderer import render_fast_batch

    h, w = 32, 48
    extra = [dict(
        rgb=rng.random((h, w, 3)).astype(np.float32),
        disp=smooth_noise(rng, h, w).astype(np.float32),
        mask=(smooth_noise(rng, h, w) > 0.4).astype(np.float32),
        focal_px=0.78 * w, invz_min=1.0, invz_max=0.1,
    )]
    proj = projector_from_arrays(
        rng.random((h, w, 3)).astype(np.float32),
        smooth_noise(rng, h, w).astype(np.float32),
        focal_px=0.78 * w, invz_min=2.0, invz_max=0.2, baseline=1.0,
        extra_layers=extra,
    )
    cam = Camera.create(w, h, focal_px=0.78 * w)
    f = 8
    positions = np.stack([[0.006 * (i + 1), 0.0, 0.0] for i in range(f)])
    mesh = sharding.make_mesh(("frame",))
    out = np.asarray(
        sharding.render_fast_trajectory_sharded(proj, positions, cam, mesh)
    )
    assert out.shape == (f, h, w, 4)
    cams = [
        Camera.create(w, h, focal_px=0.78 * w, position=p)
        for p in positions
    ]
    ref = np.asarray(render_fast_batch(proj, cams))
    np.testing.assert_allclose(out, ref, atol=2e-4)


def test_fast_trajectory_sharded_orbit(rng):
    """ORBIT (rotated-pose) trajectories shard
    across devices on the production fast kernel. The tier plans are
    pose-batch unions, so each device compiles the same target/rotated
    tier program; only the per-pose arrays shard. Output must equal the
    unsharded render_fast_batch frame-for-frame, and the routed tier
    must actually be a rotation tier (not the lateral march)."""
    from lif_tpu.core.pose import orbit_pose
    from lif_tpu.models.renderer import render_fast_batch

    h, w = 64, 128  # target tier needs a 128-divisible width
    proj = projector_from_arrays(
        rng.random((h + 16, w, 3)).astype(np.float32),
        smooth_noise(rng, h + 16, w).astype(np.float32),
        focal_px=0.78 * w, invz_min=2.0, invz_max=0.2, baseline=1.0,
    )
    center = np.array([0.0, 0.0, -1.5])
    poses = [
        orbit_pose(center, 1.5, theta=np.deg2rad(t))
        for t in np.linspace(-6, 6, 8)
    ]
    cams = [
        Camera.create(w, h, focal_px=0.78 * w, position=p, rotation=r)
        for p, r in poses
    ]
    ref, tiers = render_fast_batch(proj, cams, return_tiers=True)
    assert all(t != "march" for t in tiers), tiers
    mesh = sharding.make_mesh(("frame",))
    out = np.asarray(
        sharding.render_fast_trajectory_sharded(
            proj, [p for p, _ in poses],
            Camera.create(w, h, focal_px=0.78 * w), mesh,
            cameras_rotations=[r for _, r in poses],
        )
    )
    np.testing.assert_allclose(out, np.asarray(ref), atol=2e-4)


def test_fast_trajectory_sharded_skewed(rng):
    """Skewed frustums ride the sharded fast path (the skew fold
    works under shard_map: the fold is pose-invariant host math)."""
    from lif_tpu.models.renderer import render_fast_batch

    h, w = 32, 48
    proj = projector_from_arrays(
        rng.random((h, w, 3)).astype(np.float32),
        smooth_noise(rng, h, w).astype(np.float32),
        focal_px=0.78 * w, invz_min=2.0, invz_max=0.2, baseline=1.0,
    )
    cam = Camera.create(w, h, focal_px=0.78 * w, skew=(0.02, -0.01))
    positions = np.stack([[0.004 * (i + 1), 0.0, 0.0] for i in range(8)])
    mesh = sharding.make_mesh(("frame",))
    out = np.asarray(
        sharding.render_fast_trajectory_sharded(proj, positions, cam, mesh)
    )
    cams = [
        Camera.create(w, h, focal_px=0.78 * w, position=p,
                      skew=(0.02, -0.01))
        for p in positions
    ]
    ref = np.asarray(render_fast_batch(proj, cams, mask_mode="none"))
    np.testing.assert_allclose(out, ref, atol=2e-4)


def test_fused_projectors_view_tile(rng):
    """Fusion COMPOSED with tile sharding. On a
    (view=4, tile=2) 2-D mesh each device raycasts its projector's
    row-band; the fusion collectives reduce over the view axis per tile.
    Must equal the 1-D view-mesh fusion bit-for-bit."""
    h, w = 32, 48
    projs = [
        projector_from_arrays(
            rng.random((h, w, 3)).astype(np.float32),
            smooth_noise(rng, h, w).astype(np.float32),
            focal_px=0.78 * w, invz_min=2.0, invz_max=0.2, baseline=1.0,
            position=(0.03 * i - 0.05, 0.0, 0.0),
        )
        for i in range(4)
    ]
    cam = Camera.create(w, h, focal_px=0.78 * w, position=(0.02, 0, 0))
    mesh1 = sharding.make_mesh(("view",), devices=jax.devices()[:4])
    ref = np.asarray(sharding.render_fused_projectors(projs, cam, mesh1))
    mesh2 = sharding.make_mesh(("view", "tile"), shape=(4, 2))
    out = np.asarray(sharding.render_fused_projectors(
        projs, cam, mesh2, tile_axis="tile"
    ))
    assert out.shape == (h, w, 4)
    np.testing.assert_allclose(out, ref, atol=1e-6)
