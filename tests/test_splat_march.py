"""Tests for the batched billboard entry point (render_billboard_fast_batch:
the XLA depth-tested scatter of ops/splat.forward_splat per pose).

reference: src/shaders/holoVertex.glsl:130-149, 243-273 (billboard
instanced quads + z-buffer).
"""

import numpy as np
import pytest


IZMIN, IZMAX = 2.0, 0.1


def _smooth_scene(rng, h=64, w=96):
    """Smooth-ish random scene: boundary-coverage flips are rare."""
    base = rng.random((h // 8 + 2, w // 8 + 2))
    disp = np.kron(base, np.ones((8, 8)))[:h, :w]
    # mild smoothing via neighbor average
    disp = 0.25 * (
        disp
        + np.roll(disp, 1, 0) + np.roll(disp, 1, 1)
        + np.roll(disp, -1, 0)
    )
    rgb = rng.random((h, w, 3)).astype(np.float32)
    return rgb, disp.astype(np.float32), np.ones((h, w), np.float32)


class TestRendererEntry:
    def test_cpu_fallback_matches_per_frame(self, rng):
        """The batch equals per-frame render(mode='billboard')."""
        from lif_tpu import Camera, projector_from_arrays
        from lif_tpu.models.renderer import (
            render,
            render_billboard_fast_batch,
        )

        h, w = 64, 96
        rgb, disp, mask = _smooth_scene(rng, h, w)
        f1 = 0.78 * w
        proj = projector_from_arrays(
            rgb, disp, mask, focal_px=f1,
            invz_min=IZMIN, invz_max=IZMAX, baseline=1.0,
        )
        cams = [
            Camera.create(w, h, focal_px=f1, position=[x, 0.0, 0.0])
            for x in (0.1, 0.22)
        ]
        batch = render_billboard_fast_batch(proj, cams, to_srgb=False)
        for cam, img in zip(cams, np.asarray(batch)):
            single = render(proj, cam, mode="billboard", to_srgb=False)
            assert np.allclose(img, np.asarray(single), atol=1e-6)

    def test_rotated_pose_raises(self, rng):
        from lif_tpu import Camera, projector_from_arrays
        from lif_tpu.models.renderer import render_billboard_fast_batch
        from tests.test_rotated_march import _roty

        h, w = 64, 96
        rgb, disp, mask = _smooth_scene(rng, h, w)
        proj = projector_from_arrays(
            rgb, disp, mask, focal_px=0.78 * w,
            invz_min=IZMIN, invz_max=IZMAX, baseline=1.0,
        )
        cam = Camera.create(
            w, h, focal_px=0.78 * w, position=[0.1, 0.0, 0.0],
            rotation=_roty(5.0),
        )
        with pytest.raises(ValueError, match="lateral"):
            render_billboard_fast_batch(proj, [cam])
