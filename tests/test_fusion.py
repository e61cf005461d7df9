"""Multi-projector fusion: the sharded (pmax/psum) and single-chip fast
paths implement the same merge spec — the nearest frontmost surface
wins, with candidates inside config.fuse_tol relative inverse depth
blended by triangular weights (hard nearest-wins + tie averaging at
fuse_tol=0) — and fusion covers the full LDI stack with reference mask
semantics."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from lif_tpu import Camera, projector_from_arrays
from lif_tpu.models.renderer import render_fused_fast
from lif_tpu.parallel.sharding import make_mesh, render_fused_projectors


def _psnr(a, b):
    mse = np.mean((np.asarray(a)[..., :3] - np.asarray(b)[..., :3]) ** 2)
    return 10 * np.log10(1.0 / max(float(mse), 1e-12))


def _proj(rng, h, w, x, depth_bias=0.0, layers=1):
    rgb = rng.random((h, w, 3), dtype=np.float32)
    k = np.ones(5, np.float32) / 5.0
    for c in range(3):
        rgb[..., c] = np.apply_along_axis(
            lambda r: np.convolve(r, k, mode="same"), 1, rgb[..., c]
        )
    disp = np.clip(
        rng.uniform(0.3, 0.7, (h, w)).astype(np.float32) + depth_bias, 0.01, 0.99
    )
    extra = None
    if layers > 1:
        extra = [dict(
            rgb=rgb[::-1].copy(),
            disp=np.clip(disp * 0.5, 0.01, 0.99),
            mask=(rng.random((h, w)) > 0.3).astype(np.float32),
            focal_px=0.78 * w,
            invz_min=2.0, invz_max=0.2,
        )]
    return projector_from_arrays(
        rgb, disp, focal_px=0.78 * w, invz_min=2.0, invz_max=0.2,
        baseline=1.0, position=(x, 0.0, 0.0), extra_layers=extra,
    )


def test_fused_fast_nearest_wins(rng):
    """Two overlapping projectors: where the biased-nearer projector hits,
    its color must win the merge."""
    h, w = 64, 96
    near = _proj(rng, h, w, -0.02, depth_bias=0.25)
    far = _proj(rng, h, w, 0.02, depth_bias=-0.25)
    cam = Camera.create(w, h, focal_px=0.78 * w)
    fused = np.asarray(
        render_fused_fast([near, far], cam, to_srgb=False)
    )
    from lif_tpu.models.renderer import render_fast_view

    near_only = np.asarray(
        render_fast_view(near, cam, to_srgb=False, mask_mode="none")
    )
    # interior, away from the feathering border
    sl = (slice(12, -12), slice(16, -16))
    p = _psnr(fused[sl], near_only[sl])
    assert p > 35.0, f"nearest projector should dominate, got {p:.1f} dB"


def test_fused_fast_matches_sharded_merge(rng):
    """Single-chip render_fused_fast == the shard_map pmax/psum fusion on
    the virtual CPU mesh (identical merge spec), modulo the kernel
    difference (march vs raycast) — compared at matched kernels by
    running the sharded path's merge on the march outputs is not
    possible, so we assert the two full paths agree to march-vs-raycast
    tolerance on a smooth scene."""
    h, w = 64, 96
    projs = [_proj(rng, h, w, x) for x in (-0.03, -0.01, 0.01, 0.03)]
    cam = Camera.create(w, h, focal_px=0.78 * w)
    fused_fast = np.asarray(render_fused_fast(projs, cam))

    mesh = make_mesh(("view",), (4,), devices=jax.devices()[:4])
    fused_sharded = np.asarray(
        render_fused_projectors(projs, cam, mesh, num_steps=160)
    )
    sl = (slice(12, -12), slice(16, -16))
    p = _psnr(fused_fast[sl], fused_sharded[sl])
    assert p > 30.0, f"fusion paths disagree: {p:.1f} dB"


def test_sharded_fusion_ldi_layers(rng):
    """The sharded fusion composites ALL LDI layers (not layer 0
    only): occluded-layer content must appear where the front
    layer's mask discards it."""
    h, w = 64, 96
    projs = [_proj(rng, h, w, x, layers=2) for x in (-0.02, 0.02)]
    cam = Camera.create(w, h, focal_px=0.78 * w)
    mesh = make_mesh(("view",), (2,), devices=jax.devices()[:2])
    fused = np.asarray(
        render_fused_projectors(projs, cam, mesh, num_steps=120)
    )
    assert np.isfinite(fused).all()
    # coverage: where the front layer's mask discards, layer-1 content
    # shows through -> alpha stays high across the interior (a
    # layer-0-only fusion would leave the masked holes empty)
    interior_a = fused[12:-12, 16:-16, 3]
    assert float(interior_a.mean()) > 0.9


def test_fused_fast_batch_matches_single(rng):
    """Batched fused rendering (one dispatch) equals per-pose fusion."""
    from lif_tpu.models.renderer import render_fused_fast_batch

    h, w = 64, 96
    projs = [_proj(rng, h, w, x) for x in (-0.02, 0.02)]
    cams = [
        Camera.create(w, h, focal_px=0.78 * w, position=[x, 0.0, 0.0])
        for x in (-0.01, 0.0, 0.015)
    ]
    batched = np.asarray(render_fused_fast_batch(projs, cams))
    for i, cam in enumerate(cams):
        single = np.asarray(render_fused_fast(projs, cam))
        assert np.abs(batched[i] - single).max() < 1e-5, i


def test_fused_fast_batch_postprocess(rng):
    """postprocess= runs inside the compiled fused core (one dispatch)
    and equals applying the function after — including through the
    pose-chunked lax.map path."""
    import jax.numpy as jnp

    from lif_tpu.config import DEFAULT_CONFIG
    from lif_tpu.models.renderer import render_fused_fast_batch

    h, w = 64, 96
    projs = [_proj(rng, h, w, x) for x in (-0.02, 0.02)]
    cams = [
        Camera.create(w, h, focal_px=0.78 * w, position=[0.004 * i, 0.0, 0.0])
        for i in range(5)
    ]

    def per_frame_sum(img):
        return jnp.sum(img, axis=(1, 2, 3))

    imgs = np.asarray(render_fused_fast_batch(projs, cams))
    fused = np.asarray(
        render_fused_fast_batch(projs, cams, postprocess=per_frame_sum)
    )
    np.testing.assert_allclose(fused, imgs.sum(axis=(1, 2, 3)), rtol=1e-5)
    cfg = DEFAULT_CONFIG.replace(pose_chunk=2)
    fused_c = np.asarray(
        render_fused_fast_batch(
            projs, cams, config=cfg, postprocess=per_frame_sum
        )
    )
    np.testing.assert_allclose(fused_c, fused, rtol=1e-5)


def _smooth_scene(h, w):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    disp = (0.5 + 0.2 * np.sin(2 * np.pi * xx / w)
            * np.cos(2 * np.pi * yy / h)).astype(np.float32)
    rgb = np.stack([
        0.5 + 0.4 * np.sin(2 * np.pi * (xx + 7 * c) / (w / 3))
        * np.cos(2 * np.pi * (yy - 5 * c) / (h / 2))
        for c in range(3)
    ], axis=-1).astype(np.float32)
    return rgb, disp


def test_fused_fast_skewed_projectors(rng):
    """Skewed projectors AND a skewed camera through the single-chip
    fused fast path (no longer a ValueError): the -f1*(sk1-sk2) fold
    rides each projector's march exactly as in the batch path, and the
    result matches the skew-aware exact
    raycast fusion (render_fused_projectors, the fused oracle).
    Reference: rayCastMonoLDI.glsl:316-332 folds sk1/sk2 into every
    pose."""
    h, w = 64, 96
    rgb, disp = _smooth_scene(h, w)
    projs = [
        projector_from_arrays(
            rgb, disp, focal_px=0.78 * w, invz_min=2.0, invz_max=0.2,
            baseline=1.0, position=(x, 0.0, 0.0), skew=sk,
        )
        for x, sk in ((-0.02, (0.02, -0.01)), (0.02, (-0.015, 0.01)))
    ]
    cam = Camera.create(w, h, focal_px=0.78 * w, skew=(0.01, 0.0))
    fused_fast = np.asarray(render_fused_fast(projs, cam))

    mesh = make_mesh(("view",), (2,), devices=jax.devices()[:2])
    fused_exact = np.asarray(
        render_fused_projectors(projs, cam, mesh, num_steps=320)
    )
    sl = (slice(12, -12), slice(16, -16))
    p = _psnr(fused_fast[sl], fused_exact[sl])
    assert p > 40.0, f"skewed fusion vs exact fused oracle: {p:.1f} dB"


def test_fused_fast_skewed_single_matches_fast_view(rng):
    """A one-projector skewed 'fusion' must reduce to the (already
    golden-tested) skewed fast view — ties the fused skew fold to the
    batch path's."""
    from lif_tpu.models.renderer import render_fast_view

    h, w = 64, 96
    rgb, disp = _smooth_scene(h, w)
    proj = projector_from_arrays(
        rgb, disp, focal_px=0.78 * w, invz_min=2.0, invz_max=0.2,
        baseline=1.0, skew=(0.02, -0.015),
    )
    cam = Camera.create(
        w, h, focal_px=0.78 * w, position=[0.03, 0.0, 0.0],
        skew=(0.005, 0.01),
    )
    fused = np.asarray(render_fused_fast([proj], cam, to_srgb=False))
    view = np.asarray(
        render_fast_view(proj, cam, to_srgb=False, mask_mode="none")
    )
    p = _psnr(fused, view)
    assert p > 50.0, f"single-projector skewed fusion drifted: {p:.1f} dB"


def test_fused_nearest_wins_across_different_baselines(rng):
    """The merge key is ABSOLUTE inverse depth: a projector with surface
    at 1 m must beat one at 2 m regardless of their baselines (a double
    /baseline once made the FARTHER surface win whenever baselines
    differed)."""
    h, w = 48, 64
    red = np.zeros((h, w, 3), np.float32); red[..., 0] = 1.0
    green = np.zeros((h, w, 3), np.float32); green[..., 1] = 1.0

    def proj(rgb, depth_m, baseline):
        # disp=1 everywhere -> invz = invz_min; choose invz_min so that
        # depth = baseline/invz_min = depth_m
        invz_min = baseline / depth_m
        disp = np.ones((h, w), np.float32)
        return projector_from_arrays(
            rgb, disp, focal_px=0.78 * w, invz_min=invz_min,
            invz_max=invz_min * 1e-3, baseline=baseline,
        )

    near = proj(red, 1.0, baseline=4.0)    # 1 m away, big baseline
    far = proj(green, 2.0, baseline=1.0)   # 2 m away, small baseline
    cam = Camera.create(w, h, focal_px=0.78 * w, position=[1e-4, 0, 0])
    fused = np.asarray(
        render_fused_fast([near, far], cam, to_srgb=False)
    )
    c = fused[h // 2, w // 2]
    assert c[0] > 0.9 and c[1] < 0.1, f"nearer (red) surface must win: {c}"

    # same invariant through the sharded path
    mesh = make_mesh(("view",), (2,), devices=jax.devices()[:2])
    fused_sh = np.asarray(
        render_fused_projectors([near, far], cam, mesh, num_steps=60,
                                to_srgb=False)
    )
    c = fused_sh[h // 2, w // 2]
    assert c[0] > 0.9 and c[1] < 0.1, f"sharded: nearer must win: {c}"


def test_fused_same_scene_is_well_conditioned(rng):
    """Several projectors imaging the SAME world surface (the config-4
    bench construction, made COHERENT: each projector's rgb/depth is
    synthesized at its own pose, like the config-2 stereo pair) must
    fuse back to the base view. A hard nearest-wins merge flips winners
    on depth-discretization noise between the near-equal candidates —
    measured ~11 dB of fusion PSNR on the SFMoMA 4-projector config —
    while the triangular tolerance blend (config.fuse_tol) recovers the
    base render almost exactly (~65 dB on this scene)."""
    from lif_tpu.models.renderer import (
        render_depth_fast,
        render_fast_view,
    )

    h, w = 64, 96
    # smooth depth + smooth color (like the real scene): with random
    # per-pixel depth the synthesized views' occlusion boundaries
    # dominate and the comparison measures content, not merge
    # conditioning
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    disp = (0.5 + 0.2 * np.sin(2 * np.pi * xx / w)
            * np.cos(2 * np.pi * yy / h)).astype(np.float32)
    rgb = np.stack([
        0.5 + 0.4 * np.sin(2 * np.pi * (xx + 7 * c) / (w / 3))
        * np.cos(2 * np.pi * (yy - 5 * c) / (h / 2))
        for c in range(3)
    ], axis=-1).astype(np.float32)
    izmin, izmax = 2.0, 0.2
    base = projector_from_arrays(
        rgb, disp, focal_px=0.78 * w, invz_min=izmin, invz_max=izmax,
        baseline=1.0,
    )
    projs = []
    for i in range(4):
        pos = [0.02 * i, 0.0, 0.0]
        cam_i = Camera.create(w, h, focal_px=0.78 * w, position=pos)
        rgb_i = np.asarray(render_fast_view(
            base, cam_i, to_srgb=False, mask_mode="none"))[..., :3]
        invz_i = np.asarray(render_depth_fast(base, cam_i))
        d_i = np.clip((invz_i - izmax) / (izmin - izmax), 0, 1)
        projs.append(projector_from_arrays(
            rgb_i, d_i.astype(np.float32), focal_px=0.78 * w,
            invz_min=izmin, invz_max=izmax, baseline=1.0, position=pos,
        ))
    cam = Camera.create(w, h, focal_px=0.78 * w,
                        position=[0.05, 0.0, 0.0])
    fused = np.asarray(render_fused_fast(projs, cam, to_srgb=False))
    gold = np.asarray(render_fast_view(base, cam, to_srgb=False,
                                       mask_mode="none"))
    sl = (slice(12, -12), slice(16, -16))
    p = _psnr(fused[sl], gold[sl])
    assert p > 45.0, f"same-scene fusion degraded to {p:.1f} dB"
