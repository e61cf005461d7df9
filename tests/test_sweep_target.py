"""Golden tests for the single-phase TARGET-RAY march.

The production rotated tier: marches the full-resolution source directly
along every target ray (no intermediate aligned grid, no resampling
stage), so rotated/orbit poses get march-exact fidelity (the two-phase
rotated tier reaches only ~35-37 dB on the flagship orbit).

Oracle: ops/raycast at high step count (itself golden vs the float64
GLSL transliteration, reference src/shaders/rayCastMonoLDI.glsl:219-297).
The tier runs the dense XLA twin (render_target_xla) on every backend;
it is also checked against the float64 reference shader directly.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from lif_tpu.ops import sweep_target as st
from tests.test_rotated_march import _march_rot, _rotx, _roty
from tests.test_sweep_march import _psnr, _scene

IZMIN, IZMAX = 2.0, 0.1


def _setup(rng, rots, cs, h=96, w=128, f2=None, step_px=1.0):
    rgb, disp, mask = _scene(rng, h=h, w=w)
    f1 = 0.78 * w
    f2 = f1 if f2 is None else f2
    plan = st.plan_target(w, h, w, h, f1, f2, rots, cs, IZMIN, IZMAX)
    grids, k = st.target_plane_grids(
        rots, cs, f1, f2, w, h, w, h, IZMIN, IZMAX, step_px=step_px
    )
    poses = np.stack([
        st.target_pose_scalars(r, c, f1, f2, w, h, w, h)
        for r, c in zip(rots, cs)
    ])
    return rgb, disp, mask, f1, f2, plan, grids, k, poses


class TestPlanEligibility:
    def test_yaw_pose_plans(self):
        plan = st.plan_target(
            128, 96, 128, 96, 100.0, 100.0, [_roty(10.0)],
            [np.array([0.2, 0.0, 0.0])], IZMIN, IZMAX,
        )
        assert plan.out_w == 128 and plan.bw % 8 == 0
        assert len(plan.cm_ylims) == 1

    def test_pitch_pose_raises(self):
        # pitch makes the source x position depend on the target ROW —
        # outside the kernel's separable x-stage (the yaw gate)
        with pytest.raises(ValueError, match="row-dependent"):
            st.plan_target(
                128, 96, 128, 96, 100.0, 100.0, [_rotx(8.0)],
                [np.array([0.1, 0.0, 0.0])], IZMIN, IZMAX,
            )

    def test_odd_width_raises(self):
        with pytest.raises(ValueError, match="divisible"):
            st.plan_target(
                120, 96, 120, 96, 100.0, 100.0, [_roty(5.0)],
                [np.zeros(3)], IZMIN, IZMAX,
            )


class TestXlaTwinGolden:
    """The production fetch path (depth-only march + one exact bilinear
    color gather) vs the high-step ray-march oracle. Thresholds are on a
    RANDOM-texture scene (far harsher than natural images: every
    sub-pixel resampling difference decorrelates); the flagship-scene
    goldens (test_flagship_orbit) carry the production fidelity."""

    @pytest.mark.parametrize(
        "rot,c1,fr,floor,name",
        [
            (_roty(10.0), [0.2, 0.0, -0.02], 1.0, 44.0, "yaw+x+dolly"),
            (_roty(-6.0), [-0.1, 0.0, 0.01], 1.0, 44.0, "yaw_neg"),
            (_roty(4.0), [0.05, 0.08, 0.0], 1.0, 44.0, "yaw+xy"),
            (np.eye(3), [0.1, 0.0, -0.05], 1.2, 44.0, "zoom+dolly"),
        ],
    )
    def test_golden(self, rng, rot, c1, fr, floor, name):
        c1 = np.asarray(c1, np.float64)
        f1 = 0.78 * 128
        rgb, disp, mask, f1, f2, plan, grids, k, poses = _setup(
            rng, [rot], [c1], f2=f1 / fr
        )
        out = np.asarray(st.render_target_fetch_batch(
            rgb, disp, mask, IZMIN, IZMAX, jnp.asarray(poses),
            jnp.asarray(grids), jnp.zeros(4), plan, k,
            mask_mode="none",
        ))[0]
        ref = _march_rot(rgb, disp, mask, IZMIN, IZMAX, f1, c1, rot,
                         128, 96, steps=1280, f2=f2)
        sl = np.s_[10:-10, 10:-10]
        assert _psnr(out[sl], ref[sl]) >= floor, name

    def test_lerp_twin_close_to_fetch(self, rng):
        """The bracket color lerp (render_target_batch) tracks the fetch
        path within its known gap: the lerp is approximate off the snap
        grid, bounded ~39 dB on random textures
        at step 1 (the reason the production tier fetches)."""
        rot, c1 = _roty(4.0), np.array([0.05, 0.08, 0.0])
        rgb, disp, mask, f1, f2, plan, grids, k, poses = _setup(
            rng, [rot], [c1]
        )
        out = np.asarray(st.render_target_xla(
            rgb, disp, mask, IZMIN, IZMAX, jnp.asarray(poses[0]),
            jnp.asarray(grids[0]), jnp.zeros(4), k, 128, 96,
            mask_mode="none",
        ))
        ref = _march_rot(rgb, disp, mask, IZMIN, IZMAX, f1, c1, rot,
                         128, 96, steps=1280)
        sl = np.s_[10:-10, 10:-10]
        assert _psnr(out[sl], ref[sl]) >= 37.0


class TestTwinReference:
    """The twins on the cases the tiled kernel was checked on, against
    the float64 reference shader (tests/reference_renderer.py)."""

    @pytest.mark.parametrize("bi", [0, 1])
    def test_lerp_twin_batch(self, rng, bi):
        """render_target_batch (bracket colour lerp), pose batch of two."""
        from tests.test_sweep_scaled import reference64

        rots = [_roty(12.0), _roty(-8.0)]
        cs = [np.array([0.22, 0.0, -0.03]), np.array([-0.12, 0.05, 0.02])]
        rgb, disp, mask, f1, f2, plan, grids, k, poses = _setup(rng, rots, cs)
        out = np.asarray(st.render_target_batch(
            rgb, disp, mask, IZMIN, IZMAX, jnp.asarray(poses),
            jnp.asarray(grids), jnp.zeros(4), plan, k, mask_mode="none",
        ))[bi]
        want = reference64(rgb, disp, mask, IZMIN, IZMAX, f1, cs[bi],
                           rots[bi], 128, 96)
        sl = np.s_[10:-10, 10:-10]
        assert _psnr(out[sl], want[sl]) >= 36.0

    @pytest.mark.parametrize("step_px,refine", [(1.0, 0), (3.0, 2)])
    def test_depth_only_fetch(self, rng, step_px, refine):
        """The production fetch path (depth-only march + one bilinear
        colour gather), dense and with a widened ladder plus refine."""
        from tests.test_sweep_scaled import reference64

        rots = [_roty(10.0)]
        cs = [np.array([0.18, 0.04, -0.02])]
        rgb, disp, mask, f1, f2, plan, grids, k, poses = _setup(
            rng, rots, cs, step_px=step_px
        )
        out = np.asarray(st.render_target_fetch_batch(
            rgb, disp, mask, IZMIN, IZMAX, jnp.asarray(poses),
            jnp.asarray(grids), jnp.zeros(4), plan, k, mask_mode="none",
            refine=refine,
        ))[0]
        want = reference64(rgb, disp, mask, IZMIN, IZMAX, f1, cs[0],
                           rots[0], 128, 96)
        sl = np.s_[10:-10, 10:-10]
        assert _psnr(out[sl], want[sl]) >= 40.0


class TestDepthOnly:
    def test_widened_step_with_refine_tracks_dense_ladder(self, rng):
        """The orbit throughput lever: a step_px=3 ladder with refine=2
        must solve invz* close to the dense step_px=1 ladder (sub-plane
        evaluations restore the skipped interior planes), where the
        UNREFINED widened ladder visibly drifts."""
        rots = [_roty(10.0)]
        cs = [np.array([0.18, 0.04, -0.02])]
        rgb, disp, mask, f1, f2, plan, g1, k1, poses = _setup(
            rng, rots, cs, step_px=1.0
        )
        g3, k3 = st.target_plane_grids(
            rots, cs, f1, f2, 128, 96, 128, 96, IZMIN, IZMAX,
            step_px=3.0,
        )
        f_d, v_d = st.render_target_xla(
            rgb, disp, mask, IZMIN, IZMAX, jnp.asarray(poses[0]),
            jnp.asarray(g1[0]), jnp.zeros(4), k1, 128, 96,
            depth_only=True,
        )

        def _err(refine):
            f_w, v_w = st.render_target_xla(
                rgb, disp, mask, IZMIN, IZMAX, jnp.asarray(poses[0]),
                jnp.asarray(g3[0]), jnp.zeros(4), k3, 128, 96,
                depth_only=True, refine=refine,
            )
            agree = np.asarray(f_w) == np.asarray(f_d)
            return (
                np.abs(np.asarray(v_w) - np.asarray(v_d)) * agree,
                agree,
            )

        err_ref, agree = _err(2)
        err_raw, _ = _err(0)
        assert agree.mean() > 0.995
        # refine recovers the TYPICAL pixel to dense-ladder accuracy
        # (median ~9e-6 vs ~1.6e-4 unrefined on this scene); outlier
        # pixels where the coarse pass1 misses a thin crossing entirely
        # are not recoverable by in-bracket refinement, so the bound is
        # on the median and the large-error fraction, not the mean.
        assert np.median(err_ref) < 0.2 * max(np.median(err_raw), 1e-12)
        assert np.median(err_ref) < 5e-5
        assert (err_ref > 1e-3).mean() < 0.7 * (err_raw > 1e-3).mean()


class TestRendererRouting:
    def test_fast_batch_routes_yaw_to_target(self, rng, monkeypatch):
        """render_fast_batch must pick the target tier for yaw-family
        rotated poses (and hit march-class quality through the public
        API). Unique dims (112 rows) force a fresh core trace so the
        spy observes the call."""
        from lif_tpu import Camera
        from lif_tpu.models.projector import projector_from_arrays
        import lif_tpu.models.renderer as R

        calls = []
        orig = st.render_target_fetch_batch
        monkeypatch.setattr(
            R._sweep_target, "render_target_fetch_batch",
            lambda *a, **kw: (calls.append(1), orig(*a, **kw))[1],
        )
        h, w = 112, 128
        rgb, disp, mask = _scene(rng, h=h, w=w)
        f1 = 0.78 * w
        proj = projector_from_arrays(
            np.asarray(rgb), np.asarray(disp), focal_px=f1,
            invz_min=IZMIN, invz_max=IZMAX, baseline=1.0,
        )
        rot, c1 = _roty(8.0), np.array([0.15, 0.0, -0.01])
        cam = Camera.create(w, h, focal_px=f1, position=c1, rotation=rot)
        out = R.render_fast_batch(proj, [cam])
        assert len(calls) == 1
        from lif_tpu.core.pose import relative_view_pose
        p_rel, r_rel = relative_view_pose(
            np.zeros(3), np.eye(3), c1.astype(np.float64), rot
        )
        ref = _march_rot(rgb, disp, mask, IZMIN, IZMAX, f1, p_rel, r_rel,
                         w, h, steps=1280)
        sl = np.s_[10:-10, 10:-10]
        assert _psnr(np.asarray(out[0])[sl], ref[sl]) >= 40.0

    def test_pitch_routes_transposed_target(self, rng, monkeypatch):
        """Pitch rotations fail plan_target's yaw gate upright, but the
        renderer maps them onto the yaw family by an x<->y transpose
        (tests/test_pitch_transpose.py covers the flagship scene; this
        pins the dispatch on a synthetic odd-aspect case, h=112 ->
        transposed width 128 with a symmetric 16-px pad sliced off)."""
        from lif_tpu import Camera
        from lif_tpu.models.projector import projector_from_arrays
        import lif_tpu.models.renderer as R

        calls = []
        orig = st.render_target_fetch_batch
        monkeypatch.setattr(
            R._sweep_target, "render_target_fetch_batch",
            lambda *a, **kw: (calls.append(1), orig(*a, **kw))[1],
        )
        h, w = 112, 128
        rgb, disp, mask = _scene(rng, h=h, w=w)
        f1 = 0.78 * w
        proj = projector_from_arrays(
            np.asarray(rgb), np.asarray(disp), focal_px=f1,
            invz_min=IZMIN, invz_max=IZMAX, baseline=1.0,
        )
        rot, c1 = _rotx(6.0), np.array([0.1, 0.0, 0.0])
        cam = Camera.create(w, h, focal_px=f1, position=c1, rotation=rot)
        out, tiers = R.render_fast_batch(proj, [cam], return_tiers=True)
        assert list(tiers) == ["target"]
        assert len(calls) > 0, "transposed route must hit the target kernel"
        from lif_tpu.core.pose import relative_view_pose
        p_rel, r_rel = relative_view_pose(
            np.zeros(3), np.eye(3), c1.astype(np.float64), rot
        )
        ref = _march_rot(rgb, disp, mask, IZMIN, IZMAX, f1, p_rel, r_rel,
                         w, h, steps=1280)
        sl = np.s_[10:-10, 10:-10]
        # march class — the transposed single-phase tier replaces the
        # two-phase path's ~34 dB intermediate-lattice bound here
        assert _psnr(np.asarray(out[0])[sl], ref[sl]) >= 40.0

    def test_combined_rotation_falls_back_to_two_phase(self, rng,
                                                       monkeypatch):
        """Rotations about both axes fail the yaw gate in BOTH
        orientations (plan_target raises upright and transposed); the
        dispatch must fall through to the two-phase tier."""
        from lif_tpu import Camera
        from lif_tpu.models.projector import projector_from_arrays
        import lif_tpu.models.renderer as R

        calls = []
        orig = st.render_target_fetch_batch
        monkeypatch.setattr(
            R._sweep_target, "render_target_fetch_batch",
            lambda *a, **kw: (calls.append(1), orig(*a, **kw))[1],
        )
        h, w = 112, 128
        rgb, disp, mask = _scene(rng, h=h, w=w)
        f1 = 0.78 * w
        proj = projector_from_arrays(
            np.asarray(rgb), np.asarray(disp), focal_px=f1,
            invz_min=IZMIN, invz_max=IZMAX, baseline=1.0,
        )
        rot = _rotx(5.0) @ _roty(5.0)
        c1 = np.array([0.1, 0.0, 0.0])
        cam = Camera.create(w, h, focal_px=f1, position=c1, rotation=rot)
        out, tiers = R.render_fast_batch(proj, [cam], return_tiers=True)
        assert list(tiers) == ["rotated"]
        assert len(calls) == 0
        from lif_tpu.core.pose import relative_view_pose
        p_rel, r_rel = relative_view_pose(
            np.zeros(3), np.eye(3), c1.astype(np.float64), rot
        )
        ref = _march_rot(rgb, disp, mask, IZMIN, IZMAX, f1, p_rel, r_rel,
                         w, h, steps=1280)
        sl = np.s_[10:-10, 10:-10]
        # march class: the two-phase tier's bracket march
        # solves the exact crossing per final ray — the old ~34 dB
        # intermediate-lattice bound is gone (measured 45.7 dB here)
        assert _psnr(np.asarray(out[0])[sl], ref[sl]) >= 40.0

    def test_pose_chunked_equals_unchunked(self, rng):
        """lax.map pose chunking must be a pure batching detail."""
        from lif_tpu import Camera, RenderConfig
        from lif_tpu.models.projector import projector_from_arrays
        from lif_tpu.models.renderer import render_fast_batch

        h, w = 96, 128
        rgb, disp, mask = _scene(rng, h=h, w=w)
        f1 = 0.78 * w
        proj = projector_from_arrays(
            np.asarray(rgb), np.asarray(disp), focal_px=f1,
            invz_min=IZMIN, invz_max=IZMAX, baseline=1.0,
        )
        cams = [
            Camera.create(
                w, h, focal_px=f1,
                position=[0.05 * i - 0.1, 0.0, 0.0],
                rotation=_roty(3.0 * i - 6.0),
            )
            for i in range(5)
        ]
        big = render_fast_batch(
            proj, cams, config=RenderConfig(pose_chunk=0)
        )
        small = render_fast_batch(
            proj, cams, config=RenderConfig(pose_chunk=2)
        )
        np.testing.assert_allclose(
            np.asarray(big), np.asarray(small), atol=1e-5
        )


class TestStereoRotated:
    def test_stereo_fast_rotated_pose(self, rng):
        """Rotated-head stereo through the target tier (the
        reference's stereo shader runs arbitrary head poses at
        full rate, rayCastStereoLDI.glsl:368-436), with the exact
        kernel's confidence-keyed occlusion fill."""
        from lif_tpu import Camera
        from lif_tpu.models.projector import projector_from_arrays
        from lif_tpu.models.renderer import (
            render_stereo_fast_batch,
            render_stereo_view,
        )

        h, w = 96, 128
        rgb, disp, mask = _scene(rng, h=h, w=w)
        f1 = 0.78 * w
        mk = dict(focal_px=f1, invz_min=IZMIN, invz_max=IZMAX, baseline=1.0)
        left = projector_from_arrays(np.asarray(rgb), np.asarray(disp), **mk)
        right = projector_from_arrays(
            np.asarray(rgb), np.asarray(disp), position=[0.06, 0, 0], **mk
        )
        cam = Camera.create(
            w, h, focal_px=f1, position=[0.12, 0.0, -0.01],
            rotation=_roty(6.0),
        )
        fast = render_stereo_fast_batch(left, right, [cam])[0]
        exact = render_stereo_view(left, right, cam, num_steps=640)
        sl = np.s_[8:-8, 8:-8]
        assert not np.isnan(np.asarray(fast)).any()
        # confidence-keyed occlusion fill (the exact kernel's
        # stretch-mark rule) replaced the crossing-flag fill — the last
        # sub-40 stereo floor
        assert _psnr(np.asarray(fast)[sl], np.asarray(exact)[sl]) >= 40.0
