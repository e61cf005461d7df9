"""Property/golden tests for the connected-mesh triangle rasterizer.

The gates: flat depth => hole-free homography warp;
magnified view hole-free where the billboard splat path shows gaps;
gradient cull preserved.
"""

import numpy as np
import jax.numpy as jnp

from lif_tpu import Camera, projector_from_arrays
from lif_tpu.ops.mesh import render_connected_mesh, render_mesh_connected_view
from lif_tpu.ops.splat import render_mesh_view


def _psnr(a, b):
    mse = np.mean((np.asarray(a) - np.asarray(b)) ** 2)
    return 10 * np.log10(1.0 / max(float(mse), 1e-12))


def _smooth_rgb(rng, h, w):
    rgb = rng.random((h, w, 3), dtype=np.float32)
    k = np.ones(5, np.float32) / 5.0
    for c in range(3):
        rgb[..., c] = np.apply_along_axis(
            lambda r: np.convolve(r, k, mode="same"), 1, rgb[..., c]
        )
    return rgb


def _render(rgb, disp, pos, f2=None, out_w=None, out_h=None, **kw):
    h, w = disp.shape
    f1 = 0.78 * w
    return render_connected_mesh(
        jnp.asarray(rgb), jnp.asarray(disp),
        jnp.float32(2.0), jnp.float32(0.2), jnp.float32(1.0),
        jnp.float32(f1), jnp.float32(f1),
        jnp.float32(w / 2), jnp.float32(h / 2),
        jnp.eye(3), jnp.asarray(pos, jnp.float32),
        jnp.float32(f2 if f2 is not None else f1),
        out_w=out_w or w, out_h=out_h or h,
        background=jnp.zeros(4), to_srgb=False, **kw,
    )


def _corner_blur_expected(rgb):
    """The reference's mesh-mode shading at identity: vertex colors are
    texture fetches AT pixel corners (= 4-pixel averages on a clamped
    texture), interpolated across the triangles; a pixel center sits on
    the quad diagonal, so its value is the mean of the BL and TR corner
    colors (holoVertex.glsl:180, holoFragment.glsl:47 `fragColor =
    vColor`)."""
    p = np.pad(rgb, ((1, 1), (1, 1), (0, 0)), mode="edge")
    corners = 0.25 * (p[:-1, :-1] + p[:-1, 1:] + p[1:, :-1] + p[1:, 1:])
    return 0.5 * (corners[1:, :-1] + corners[:-1, 1:])


def test_identity_passthrough(rng):
    """Identity pose, flat depth: hole-free, and the shading equals the
    reference's corner-interpolated colors exactly."""
    h, w = 48, 64
    rgb = _smooth_rgb(rng, h, w)
    disp = np.full((h, w), 0.6, np.float32)
    out = np.asarray(_render(rgb, disp, [0.0, 0.0, 0.0]))
    assert float(out[..., 3].min()) == 1.0, "holes in identity render"
    expected = _corner_blur_expected(rgb)
    p = _psnr(out[1:-1, 1:-1, :3], expected[1:-1, 1:-1])
    assert p > 40.0, f"identity shading {p:.1f} dB vs corner-interp"


def test_flat_depth_translation_is_hole_free_shift(rng):
    """Flat depth + lateral translation => a uniform parallax shift with
    NO holes (the connected topology's defining property)."""
    h, w = 48, 64
    rgb = _smooth_rgb(rng, h, w)
    disp = np.full((h, w), 0.5, np.float32)
    invz = 0.2 + (2.0 - 0.2) * 0.5  # decoded inverse depth
    shift = 2  # exact integer-pixel parallax, so centers stay on diagonals
    cx = -shift / (0.78 * w * invz)
    out = np.asarray(_render(rgb, disp, [cx, 0.0, 0.0]))
    # projector at -x => content shifts LEFT; everything except the
    # vacated right edge is covered: the mesh stretches to the borders
    interior = out[:, : w - shift - 1]
    assert float(interior[..., 3].min()) == 1.0, "holes in flat-depth warp"
    # the content equals the corner-interpolated source shifted by `shift`
    expected = _corner_blur_expected(rgb)[:, shift : w - 1]
    p = _psnr(interior[1:-1, :, :3], expected[1:-1])
    assert p > 38.0, f"shifted content only {p:.1f} dB"


def test_magnification_hole_free_where_billboard_has_gaps(rng):
    """2x magnification (f2 = 2 f1): footprint-1 billboard splats leave
    gaps; connected triangles must not."""
    h, w = 48, 64
    rgb = _smooth_rgb(rng, h, w)
    disp = rng.uniform(0.4, 0.6, (h, w)).astype(np.float32)
    f1 = 0.78 * w
    mesh = np.asarray(
        _render(rgb, disp, [0.0, 0.0, 0.0], f2=2 * f1, max_quad_px=4)
    )
    # billboard comparison: footprint 1, same pose/intrinsics
    from lif_tpu.ops.splat import forward_splat

    bb = np.asarray(
        forward_splat(
            jnp.asarray(rgb), jnp.asarray(disp),
            jnp.float32(2.0), jnp.float32(0.2), jnp.float32(1.0),
            jnp.float32(f1), jnp.float32(f1),
            jnp.float32(w / 2), jnp.float32(h / 2),
            jnp.eye(3), jnp.zeros(3),
            jnp.float32(2 * f1),
            out_w=w, out_h=h, background=jnp.zeros(4),
            footprint=1, to_srgb=False,
        )
    )
    # central crop maps to the interior of the source under 2x zoom
    crop = (slice(h // 4, -h // 4), slice(w // 4, -w // 4))
    bb_cov = float((bb[crop][..., 3] > 0).mean())
    mesh_cov = float((mesh[crop][..., 3] > 0).mean())
    assert bb_cov < 0.6, f"billboard unexpectedly covers {bb_cov:.2f}"
    assert mesh_cov == 1.0, f"mesh coverage only {mesh_cov:.2f}"


def test_gradient_cull_drops_depth_cliff(rng):
    """A steep depth edge is culled when delta_invz_threshold is small:
    the stretched triangles across the cliff disappear (alpha 0)."""
    h, w = 48, 64
    rgb = _smooth_rgb(rng, h, w)
    disp = np.full((h, w), 0.2, np.float32)
    disp[:, : w // 2] = 0.9  # near slab on the left, cliff at w//2
    # without cull: the cliff produces stretched cover between the slabs
    free = np.asarray(
        _render(rgb, disp, [-0.05, 0.0, 0.0], delta_invz_threshold=0.0)
    )
    culled = np.asarray(
        _render(rgb, disp, [-0.05, 0.0, 0.0], delta_invz_threshold=0.1)
    )
    # the culled render must lose coverage relative to the free render
    assert float(culled[..., 3].sum()) < float(free[..., 3].sum()) - 10, (
        culled[..., 3].sum(), free[..., 3].sum(),
    )


def test_view_wrapper_matches_kernel(rng):
    """render_mesh_connected_view == render_connected_mesh through the
    Projector/Camera plumbing (pose conventions, GL cy flip)."""
    h, w = 48, 64
    rgb = _smooth_rgb(rng, h, w)
    disp = rng.uniform(0.3, 0.7, (h, w)).astype(np.float32)
    proj = projector_from_arrays(
        rgb, disp, focal_px=0.78 * w, invz_min=2.0, invz_max=0.2, baseline=1.0
    )
    cam = Camera.create(w, h, focal_px=0.78 * w, position=[0.02, 0.01, 0.0])
    via_view = np.asarray(
        render_mesh_connected_view(proj, cam, to_srgb=False)
    )
    pos, rot = np.asarray([-0.02, -0.01, 0.0]), np.eye(3)
    direct = np.asarray(
        _render(rgb, disp, pos * np.array([1.0, 1.0, 1.0]))
    )
    # same kernel modulo the wrapper's cy/pose plumbing; compare coverage
    # and overall content
    assert abs(float(via_view[..., 3].mean()) - float(direct[..., 3].mean())) < 0.02
    p = _psnr(via_view[..., :3], direct[..., :3])
    assert p > 20.0, f"wrapper disagrees with kernel: {p:.1f} dB"
