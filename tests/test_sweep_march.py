"""Golden tests for the first-crossing translation march (the fast path).

The oracle chain: ops/raycast (golden-tested against the float64 reference
renderer) -> sweep_march XLA (this file: >=40 dB vs the march at high step
count) -> the Pallas (Triton) GPU kernel (equality with the XLA version in
interpret mode here; on the card, chip_smoke.py compares the compiled
kernel with the twin at 1280x800).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from lif_tpu.ops import raycast, sweep_march
from lif_tpu.ops.sweep_march_gpu import (
    prepare_lateral_source,
    render_translation_batch_gpu,
)


def render_translation_pallas(*args, **kw):
    """One pose through the GPU kernel in interpret mode."""
    a = list(args)
    a[5] = jnp.asarray(a[5], jnp.float32)[None]
    kw["interpret"] = True
    out = render_translation_batch_gpu(*a, **kw)
    return tuple(o[0] for o in out) if kw.get("raw") else out[0]


def render_translation_batch_pallas(*args, **kw):
    kw["interpret"] = True
    return render_translation_batch_gpu(*args, **kw)


def _scene(rng, h=96, w=128):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    disp = 0.5 + 0.3 * np.sin(xx / 17) * np.cos(yy / 13)
    disp[30:60, 40:80] = 0.95  # near box: a hard depth edge
    rgb = rng.random((h, w, 3), dtype=np.float32)
    # local smoothing so bilinear-vs-plane-lerp differences are realistic
    k = np.ones(5, np.float32) / 5.0
    for c in range(3):
        rgb[..., c] = np.apply_along_axis(
            lambda r: np.convolve(r, k, mode="same"), 1, rgb[..., c]
        )
    mask = np.ones((h, w), np.float32)
    return rgb.astype(np.float32), disp.astype(np.float32), mask


def _march(rgb, disp, mask, izmin, izmax, f1, c1, w, h, steps=160, f2=None):
    f2 = f1 if f2 is None else f2
    return np.asarray(
        raycast.render_mono(
            jnp.asarray(rgb[None]),
            jnp.asarray(disp[None]),
            jnp.asarray(mask[None]),
            jnp.asarray([[w, h]], jnp.float32),
            jnp.asarray([izmin]),
            jnp.asarray([izmax]),
            jnp.asarray([f1]),
            jnp.zeros(2),
            jnp.asarray(c1),
            jnp.eye(3),
            jnp.float32(f2),
            jnp.zeros(2),
            jnp.zeros(4),
            out_w=w,
            out_h=h,
            num_layers=1,
            num_steps=steps,
            mask_mode="none",
        )
    )


def _planes(disp, izmin, izmax, K):
    kq = K - K // 4
    qs = np.quantile(disp, np.linspace(0.002, 0.998, kq)).astype(np.float32)
    vals = np.concatenate(
        [
            izmax + (izmin - izmax) * qs,
            izmax
            + (izmin - izmax) * np.linspace(0.001, 0.999, K - kq).astype(np.float32),
        ]
    )
    vals = np.sort(vals)[::-1].copy()
    return vals - np.arange(K, dtype=np.float32) * (izmin - izmax) * 1e-6


def _psnr(a, b):
    mse = np.mean((a[..., :3] - b[..., :3]) ** 2)
    return 10 * np.log10(1.0 / max(mse, 1e-12))


def test_translation_march_matches_converged_march(rng):
    """The gather-free first-crossing sweep reproduces the ray march's
    surface (>=40 dB vs the CONVERGED march; the 40-step march's own error
    vs converged is the reference's noise floor — see docs/DESIGN.md)."""
    rgb, disp, mask = _scene(rng)
    h, w = disp.shape
    izmin, izmax = 2.0, 0.1
    f1 = 0.78 * w
    c1 = np.array([0.06, 0.025, 0.0], np.float32)
    K = 192
    plane = _planes(disp, izmin, izmax, K)
    plan = sweep_march.translation_plan(
        w, h, w, h, f1 * abs(c1[0]) * izmin, f1 * abs(c1[1]) * izmin
    )
    img = np.asarray(
        sweep_march.render_translation_xla(
            jnp.asarray(rgb), jnp.asarray(disp), jnp.asarray(mask),
            izmin, izmax, jnp.asarray(c1), f1, jnp.asarray(plane),
            jnp.zeros(4), plan=plan, num_planes=K, mask_mode="none",
        )
    )
    ref = _march(rgb, disp, mask, izmin, izmax, f1, c1, w, h, steps=160)
    p = _psnr(img, ref)
    assert p >= 40.0, f"only {p:.1f} dB vs the converged march"
    # alpha fields agree too (hit validity + taper)
    assert np.mean(np.abs(img[..., 3] - ref[..., 3])) < 5e-3


def test_pallas_kernel_equals_xla_oracle(rng):
    """The GPU kernel is arithmetically identical to the XLA formulation
    (lateral case), verified in interpret mode."""
    h, w = 96, 128
    disp = rng.random((h, w), dtype=np.float32)
    rgb = rng.random((h, w, 3), dtype=np.float32)
    mask = (rng.random((h, w)) > 0.2).astype(np.float32)
    izmin, izmax = 2.0, 0.1
    f1 = 0.78 * w
    c1 = np.array([0.05, 0.0, 0.0], np.float32)
    bg = np.asarray([0.1, 0.2, 0.3, 1.0], np.float32)
    K = 64
    plane = (izmax + (izmin - izmax) * np.linspace(0.999, 0.001, K)).astype(
        np.float32
    )
    plan = sweep_march.translation_plan(w, h, w, h, f1 * abs(c1[0]) * izmin, 0.0)
    args = (
        jnp.asarray(rgb), jnp.asarray(disp), jnp.asarray(mask),
        izmin, izmax, jnp.asarray(c1), f1, jnp.asarray(plane), jnp.asarray(bg),
    )
    for mode in ("multiply", "none"):
        a = np.asarray(
            sweep_march.render_translation_xla(
                *args, plan=plan, num_planes=K, mask_mode=mode
            )
        )
        b = np.asarray(
            render_translation_pallas(
                *args, plan=plan, num_planes=K, mask_mode=mode, interpret=True
            )
        )
        assert np.abs(a - b).max() < 3e-5, mode


def test_first_plane_crossing_snaps_to_nearest_plane(rng):
    """disp == 1.0 everywhere: every ray crosses at the first plane; the
    solved surface must sit at invz_min, not at 0 (a k==0 bug once put
    it there)."""
    h, w = 32, 64
    disp = np.ones((h, w), np.float32)
    rgb = rng.random((h, w, 3), dtype=np.float32)
    mask = np.ones((h, w), np.float32)
    izmin, izmax = 2.0, 0.2
    f1 = 0.78 * w
    c1 = np.array([0.05, 0.0, 0.0], np.float32)
    K = 16
    plane = (izmax + (izmin - izmax) * np.linspace(0.999, 0.001, K)).astype(
        np.float32
    )
    plan = sweep_march.translation_plan(w, h, w, h, f1 * 0.05 * izmin, 0.0)
    img = np.asarray(
        sweep_march.render_translation_xla(
            jnp.asarray(rgb), jnp.asarray(disp), jnp.asarray(mask),
            izmin, izmax, jnp.asarray(c1), f1, jnp.asarray(plane),
            jnp.zeros(4), plan=plan, num_planes=K, mask_mode="none",
        )
    )
    ref = _march(rgb, disp, mask, izmin, izmax, f1, c1, w, h, steps=160)
    # interior pixels must match the march (shift of ~izmin*f*c pixels)
    assert _psnr(img[4:-4, 12:-12], ref[4:-4, 12:-12]) > 40.0


def test_refine_matches_oracle(rng):
    """Sub-bracket refinement: the kernel (interpret) == the refined XLA
    oracle, and refinement never DEGRADES fidelity. The
    sub-sweep also warps COLOR at the sub-planes (the outer-plane color
    lerp was a bracket-wide tent blur), so on sparse grids refine now
    genuinely lifts PSNR — it is the march_stride companion knob
    (stride-s grids + refine = s-1 reproduce the dense snap grid
    exactly; see config.march_stride)."""
    rgb, disp, mask = _scene(rng)
    h, w = disp.shape
    izmin, izmax = 2.0, 0.1
    f1 = 0.78 * w
    c1 = np.array([0.06, 0.0, 0.0], np.float32)
    K = 10  # sparse: sub-planes must still land inside valid brackets
    plane = _planes(disp, izmin, izmax, K)
    plan = sweep_march.translation_plan(w, h, w, h, f1 * abs(c1[0]) * izmin, 0.0)
    args = (
        jnp.asarray(rgb), jnp.asarray(disp), jnp.asarray(mask),
        izmin, izmax, jnp.asarray(c1), f1, jnp.asarray(plane), jnp.zeros(4),
    )
    ref = _march(rgb, disp, mask, izmin, izmax, f1, c1, w, h, steps=320)
    psnrs = {}
    for refine in (0, 3):
        a = np.asarray(
            sweep_march.render_translation_xla(
                *args, plan=plan, num_planes=K, mask_mode="none",
                refine=refine,
            )
        )
        b = np.asarray(
            render_translation_pallas(
                *args, plan=plan, num_planes=K, mask_mode="none",
                refine=refine, interpret=True,
            )
        )
        assert np.abs(a - b).max() < 1e-4, f"refine={refine}"
        psnrs[refine] = _psnr(a, ref)
    assert psnrs[3] > psnrs[0] - 0.5, psnrs  # refine must not hurt


def test_pallas_batch_equals_per_pose(rng):
    """The pose-batched kernel (one launch, poses on a grid axis) matches
    per-pose renders exactly (interpret mode)."""
    h, w = 96, 128
    disp = rng.random((h, w), dtype=np.float32)
    rgb = rng.random((h, w, 3), dtype=np.float32)
    mask = np.ones((h, w), np.float32)
    izmin, izmax = 2.0, 0.1
    f1 = 0.78 * w
    bg = np.asarray([0.1, 0.2, 0.3, 1.0], np.float32)
    K = 48
    plane = (izmax + (izmin - izmax) * np.linspace(0.999, 0.001, K)).astype(
        np.float32
    )
    cxs = np.asarray([0.01, 0.035, 0.06], np.float32)
    c1_b = np.stack([cxs, np.zeros(3, np.float32), np.zeros(3, np.float32)], -1)
    plan = sweep_march.translation_plan(
        w, h, w, h, f1 * float(cxs.max()) * izmin, 0.0
    )
    batched = np.asarray(
        render_translation_batch_pallas(
            jnp.asarray(rgb), jnp.asarray(disp), jnp.asarray(mask),
            izmin, izmax, jnp.asarray(c1_b), f1, jnp.asarray(plane),
            jnp.asarray(bg), plan=plan, num_planes=K, interpret=True,
        )
    )
    # the hoisted source prep gives the same result as the inline one
    prepared = render_translation_batch_pallas(
        None, None, None,
        izmin, izmax, jnp.asarray(c1_b), f1, jnp.asarray(plane),
        jnp.asarray(bg), plan=plan, num_planes=K,
        prepared=prepare_lateral_source(
            jnp.asarray(rgb), jnp.asarray(disp), jnp.asarray(mask), plan
        ),
    )
    assert np.abs(batched - np.asarray(prepared)).max() == 0.0
    for i in range(3):
        single = np.asarray(
            render_translation_pallas(
                jnp.asarray(rgb), jnp.asarray(disp), jnp.asarray(mask),
                izmin, izmax, jnp.asarray(c1_b[i]), f1, jnp.asarray(plane),
                jnp.asarray(bg), plan=plan, num_planes=K, interpret=True,
            )
        )
        assert np.abs(batched[i] - single).max() < 1e-4, i


def test_render_fast_batch_matches_per_frame(rng):
    """renderer.render_fast_batch == per-frame render_fast_view, for both
    the lateral (march) batch and the rotated fallback batch."""
    from lif_tpu import Camera, projector_from_arrays, render_fast_batch
    from lif_tpu.models.renderer import render_fast_view

    h, w = 64, 128
    rgb, disp, mask = _scene(rng, h=h, w=w)
    proj = projector_from_arrays(
        rgb, disp, focal_px=0.78 * w, invz_min=2.0, invz_max=0.1, baseline=1.0
    )
    # lateral batch
    cams = [
        Camera.create(w, h, focal_px=0.78 * w, position=[0.02 * i, 0.0, 0.0])
        for i in range(1, 4)
    ]
    batched = np.asarray(render_fast_batch(proj, cams, num_planes=48))
    for i, cam in enumerate(cams):
        single = np.asarray(render_fast_view(proj, cam, num_planes=48))
        assert np.abs(batched[i] - single).max() < 1e-5, f"lateral frame {i}"

    # rotated batch (the in-jit loop path)
    ry = np.array(
        [[np.cos(0.02), 0, np.sin(0.02)], [0, 1, 0], [-np.sin(0.02), 0, np.cos(0.02)]],
        np.float64,
    )
    cams_r = [
        Camera.create(
            w, h, focal_px=0.78 * w, position=[0.02 * i, 0.0, 0.0], rotation=ry
        )
        for i in range(1, 3)
    ]
    batched_r = np.asarray(render_fast_batch(proj, cams_r, num_planes=24))
    for i, cam in enumerate(cams_r):
        single = np.asarray(render_fast_view(proj, cam, num_planes=24))
        assert np.abs(batched_r[i] - single).max() < 1e-5, f"rotated frame {i}"


def test_snap_grid_shift_tables_are_exact_integers(rng):
    """Snap grids place planes at integer parallax; plane_tables must
    deliver fx == 0.0 EXACTLY there (it snaps the ~1e-4 px f32 table
    drift), so the warp at those planes is an exact copy of the source,
    which is what makes the snap-grid secant exact."""
    import jax.numpy as jnp

    f1, cx, izmin, izmax = 997.3, 0.137, 2.0, 0.1
    plane, K = sweep_march.snap_plane_table(f1, cx, izmin, izmax)
    plan = sweep_march.translation_plan(
        1280, 800, 1280, 800, f1 * cx * izmin, 0.0
    )
    ix, fx, _, _ = sweep_march.plane_tables(
        plan, jnp.asarray(plane), jnp.asarray([cx, 0.0, 0.0]), f1
    )
    fx = np.asarray(fx)
    # only REAL planes: the bucketing pad sits above izmin (thresholds
    # > 1, never crossed — its shifts are legitimately fractional), and
    # the range endpoints may land off-integer by construction
    real = np.asarray(plane) <= izmin + 1e-6
    frac = fx[real]
    assert (frac == 0.0).mean() > 0.95, (
        f"only {(frac == 0.0).mean():.0%} of snap-plane shifts are exact "
        "integers — the slice branch is not being taken"
    )


def test_render_fast_batch_fused_postprocess(rng):
    """postprocess= runs INSIDE the compiled core (one dispatch instead
    of render + a separately-jitted postprocess) and
    must equal applying the same function to the returned batch — on the
    plain path, the odd-width (wpad) path, and the pose-chunked path."""
    import jax.numpy as jnp

    from lif_tpu import Camera, projector_from_arrays, render_fast_batch
    from lif_tpu.config import DEFAULT_CONFIG

    h, w = 64, 124  # 124 % 8 != 0 -> the width-pad path
    rgb, disp, _ = _scene(rng, h=h, w=w)
    proj = projector_from_arrays(
        rgb, disp, focal_px=0.78 * w, invz_min=2.0, invz_max=0.1, baseline=1.0
    )
    cams = [
        Camera.create(w, h, focal_px=0.78 * w, position=[0.015 * i, 0.0, 0.0])
        for i in range(1, 6)
    ]

    def reduce_img(img):
        return jnp.sum(img, axis=(1, 2, 3))

    imgs = np.asarray(render_fast_batch(proj, cams, num_planes=48))
    assert imgs.shape == (5, h, w, 4)
    fused = np.asarray(
        render_fast_batch(proj, cams, num_planes=48, postprocess=reduce_img)
    )
    np.testing.assert_allclose(fused, imgs.sum(axis=(1, 2, 3)), rtol=1e-5)

    # pose-chunked: 5 poses over chunks of 2 (lax.map inside the jit)
    cfg = DEFAULT_CONFIG.replace(pose_chunk=2)
    fused_c = np.asarray(
        render_fast_batch(
            proj, cams, num_planes=48, config=cfg, postprocess=reduce_img
        )
    )
    np.testing.assert_allclose(fused_c, fused, rtol=1e-5)


def test_renderer_fast_auto_uses_march(rng):
    """render(mode='fast') on a lateral pose goes through the march path
    and agrees with the exact ray march."""
    from lif_tpu import Camera, projector_from_arrays, render

    h, w = 96, 128
    rgb, disp, mask = _scene(rng)
    proj = projector_from_arrays(
        rgb, disp, focal_px=0.78 * w, invz_min=2.0, invz_max=0.1, baseline=1.0
    )
    cam = Camera.create(w, h, focal_px=0.78 * w, position=[0.06, 0.0, 0.0])
    img = np.asarray(render(proj, cam, mode="fast", num_planes=128))
    ref = np.asarray(
        render(proj, cam, mode="raycast", mask_mode="none", num_steps=160)
    )
    # bound: BOTH sides are discretizations — the 160-step oracle's
    # step-halving march vs an explicit 128-plane cap (num_planes=128
    # subsamples the snap grid at 2-px stride); their disagreement is the
    # oracle's own quantization class, not a fast-path regression
    assert _psnr(img, ref) >= 38.0


def test_y_translation_transposed_march(rng):
    """Vertical-only camera motion maps onto the x-march via the
    transpose reduction and matches the exact ray march."""
    from lif_tpu import Camera, projector_from_arrays
    from lif_tpu.models.renderer import render_fast_view, render_mono_view

    h, w = 96, 128
    rgb, disp, mask = _scene(rng, h=h, w=w)
    proj = projector_from_arrays(
        rgb, disp, focal_px=0.78 * w, invz_min=2.0, invz_max=0.1,
        baseline=1.0,
    )
    cam = Camera.create(w, h, focal_px=0.78 * w, position=[0.0, 0.04, 0.0])
    ref = np.asarray(render_mono_view(proj, cam, mask_mode="none",
                                      num_steps=320))
    fast = np.asarray(render_fast_view(proj, cam))
    assert fast.shape == ref.shape
    sl = np.s_[10:-10, 8:-8]
    p = _psnr(fast[sl], ref[sl])
    assert p > 42.0, f"y-translation march only {p:.1f} dB"


def test_outpainted_layer_march(rng):
    """A layer LARGER than the view (outpainted LDI,
    LifLoader.ts:521-526) rides the march: the centered x-window offset
    goes through the shift tables and the vertical margin is
    center-cropped, with validity/taper kept in the uncropped layer
    space. Golden vs the exact march."""
    from lif_tpu import Camera, projector_from_arrays
    from lif_tpu.models.renderer import render_fast_view, render_mono_view

    oh, ow = 96, 128          # camera / output dims
    sh, sw = oh + 16, ow + 32  # outpainted layer dims (even margins)
    rgb, disp, mask = _scene(rng, h=sh, w=sw)
    proj = projector_from_arrays(
        rgb, disp, focal_px=0.78 * ow, invz_min=2.0, invz_max=0.1,
        baseline=1.0,
    )
    cam = Camera.create(ow, oh, focal_px=0.78 * ow,
                        position=[0.05, 0.0, 0.0])
    ref = np.asarray(render_mono_view(proj, cam, mask_mode="none",
                                      num_steps=320))
    fast = np.asarray(render_fast_view(proj, cam, mask_mode="none"))
    assert fast.shape == ref.shape
    sl = np.s_[6:-6, 8:-8]
    p = _psnr(fast[sl], ref[sl])
    assert p > 42.0, f"outpainted march only {p:.1f} dB"
    # no spurious edge feather: the outpaint margin keeps the view
    # interior fully opaque where the march hit
    assert float(fast[sl][..., 3].min()) > 0.9


def test_outpainted_layer_march_batch(rng):
    """Batched path: outpainted layers match per-frame renders."""
    from lif_tpu import Camera, projector_from_arrays, render_fast_batch
    from lif_tpu.models.renderer import render_fast_view

    oh, ow = 64, 128
    sh, sw = oh + 16, ow + 32
    rgb, disp, mask = _scene(rng, h=sh, w=sw)
    proj = projector_from_arrays(
        rgb, disp, focal_px=0.78 * ow, invz_min=2.0, invz_max=0.1,
        baseline=1.0,
    )
    cams = [
        Camera.create(ow, oh, focal_px=0.78 * ow, position=[0.02 * i, 0, 0])
        for i in range(1, 4)
    ]
    batched = np.asarray(render_fast_batch(proj, cams, mask_mode="none"))
    for i, cam in enumerate(cams):
        single = np.asarray(render_fast_view(proj, cam, mask_mode="none"))
        assert np.abs(batched[i] - single).max() < 1e-4, i


def test_render_depth_fast_identity_and_parallax(rng):
    """render_depth_fast returns the solved surface inverse depth in LIF
    units: at identity it reproduces the decoded disparity map; at a
    lateral pose it matches the march's own surface (warped disp)."""
    from lif_tpu import Camera, projector_from_arrays, render_depth_fast

    h, w = 64, 96
    rgb, disp, mask = _scene(rng, h=h, w=w)
    izmin, izmax, baseline = 1.8, 0.09, 0.5
    proj = projector_from_arrays(
        rgb, disp, focal_px=0.78 * w, invz_min=izmin, invz_max=izmax,
        baseline=baseline,
    )
    cam0 = Camera.create(w, h, focal_px=0.78 * w)
    z0 = np.asarray(render_depth_fast(proj, cam0))
    expect = izmax + (izmin - izmax) * disp  # LIF units
    sl = np.s_[4:-4, 6:-6]
    assert np.abs(z0[sl] - expect[sl]).max() < 2e-2 * (izmin - izmax)

    cam1 = Camera.create(w, h, focal_px=0.78 * w, position=[0.03, 0, 0])
    z1 = np.asarray(render_depth_fast(proj, cam1))
    assert z1.shape == (h, w)
    assert np.isfinite(z1).all()
    # parallax moved the surface: the maps differ where depth varies
    assert np.abs(z1[sl] - z0[sl]).max() > 1e-3


def test_odd_width_pad_and_slice_march(rng):
    """A non-8-divisible output width (1279-style crop) stays on the
    march path via pad-and-slice: the renderer marches a wpad-wider band
    carrying a constant wpad/2 x-offset (the skew-fold mechanism) and
    slices the true width. Golden vs the exact ray march at the SAME
    odd-width camera."""
    from lif_tpu import Camera, projector_from_arrays
    from lif_tpu.models.renderer import (
        render_fast_batch,
        render_fast_view,
        render_mono_view,
    )

    h, w = 96, 127  # w % 8 == 7 -> wpad = 1, dx = 0.5
    rgb, disp, mask = _scene(rng, h=h, w=w)
    proj = projector_from_arrays(
        rgb, disp, focal_px=0.78 * w, invz_min=2.0, invz_max=0.1,
        baseline=1.0,
    )
    cam = Camera.create(w, h, focal_px=0.78 * w, position=[0.05, 0.0, 0.0])
    fast = np.asarray(render_fast_view(proj, cam, method="march"))
    assert fast.shape == (h, w, 4)
    ref = np.asarray(render_mono_view(proj, cam, mask_mode="none",
                                      num_steps=320))
    sl = np.s_[8:-8, 8:-8]
    p = _psnr(fast[sl], ref[sl])
    assert p > 42.0, f"odd-width march only {p:.1f} dB"

    # batched entry point takes the same pad-and-slice route
    cams = [
        Camera.create(w, h, focal_px=0.78 * w, position=[0.05 + 0.01 * i, 0, 0])
        for i in range(3)
    ]
    batch = np.asarray(render_fast_batch(proj, cams, method="march"))
    assert batch.shape == (3, h, w, 4)
    single = np.asarray(render_fast_view(proj, cams[1], method="march"))
    assert _psnr(batch[1], single) > 50.0


def _kernel_case(rng, h, w, mask_frac=0.2):
    disp = rng.random((h, w), dtype=np.float32)
    rgb = rng.random((h, w, 3), dtype=np.float32)
    mask = (rng.random((h, w)) > mask_frac).astype(np.float32)
    return jnp.asarray(rgb), jnp.asarray(disp), jnp.asarray(mask)


@pytest.mark.parametrize(
    "mask_mode,refine",
    [("multiply", 0), ("none", 0), ("hard", 0), ("none", 2), ("multiply", 3)],
)
def test_gpu_kernel_matches_twin_interpret(rng, mask_mode, refine):
    """Kernel (interpret) vs the XLA twin for every mask mode and with
    in-bracket refine, on a pose batch."""
    h, w = 48, 128
    rgb, disp, mask = _kernel_case(rng, h, w)
    izmin, izmax, f1 = 2.0, 0.1, 0.78 * w
    K = 32
    plane = (izmax + (izmin - izmax) * np.linspace(0.999, 0.001, K)).astype(
        np.float32
    )
    cxs = [0.02, -0.04]
    c1_b = np.array([[c, 0.0, 0.0] for c in cxs], np.float32)
    plan = sweep_march.translation_plan(w, h, w, h, f1 * 0.04 * izmin, 0.0)
    bg = jnp.asarray([0.1, 0.2, 0.3, 1.0], jnp.float32)
    out = np.asarray(render_translation_batch_pallas(
        rgb, disp, mask, izmin, izmax, jnp.asarray(c1_b), f1,
        jnp.asarray(plane), bg, plan=plan, num_planes=K,
        mask_mode=mask_mode, refine=refine,
    ))
    for i in range(len(cxs)):
        ref = np.asarray(sweep_march.render_translation_xla(
            rgb, disp, mask, izmin, izmax, jnp.asarray(c1_b[i]), f1,
            jnp.asarray(plane), bg, plan=plan, num_planes=K,
            mask_mode=mask_mode, refine=refine,
        ))
        assert np.abs(out[i] - ref).max() < 1e-4, (mask_mode, refine, i)


@pytest.mark.parametrize("h,w", [(36, 100), (40, 200), (8, 136)])
def test_gpu_kernel_pads_odd_shapes(rng, h, w):
    """Output sizes that are not tile multiples: the wrapper pads the
    grid to (8, 128) tiles and slices the true image back."""
    rgb, disp, mask = _kernel_case(rng, h, w)
    izmin, izmax, f1 = 2.0, 0.1, 0.78 * w
    K = 16
    plane = (izmax + (izmin - izmax) * np.linspace(0.999, 0.001, K)).astype(
        np.float32
    )
    c1 = np.array([0.05, 0.0, 0.0], np.float32)
    plan = sweep_march.translation_plan(w, h, w, h, f1 * 0.05 * izmin, 0.0)
    args = (rgb, disp, mask, izmin, izmax, jnp.asarray(c1), f1,
            jnp.asarray(plane), jnp.zeros(4))
    out = np.asarray(render_translation_pallas(
        *args, plan=plan, num_planes=K, mask_mode="multiply"))
    ref = np.asarray(sweep_march.render_translation_xla(
        *args, plan=plan, num_planes=K, mask_mode="multiply"))
    assert out.shape == (h, w, 4)
    assert np.abs(out - ref).max() < 1e-4


def test_gpu_kernel_raw_outputs_and_snap_tables(rng):
    """raw=True returns the twin's (rgba, alpha, hit, invz) per pose, on
    per-pose snap grids with a skew offset and an outpaint crop."""
    h, w = 32, 128
    rgb, disp, mask = _kernel_case(rng, h, w, mask_frac=0.0)
    izmin, izmax, f1 = 2.0, 0.1, 0.78 * w
    cxs = [0.03, 0.06]
    tabs, K = sweep_march.snap_plane_tables_batch(
        f1, cxs, izmin, izmax, phase_px=0.25
    )
    c1_b = np.array([[c, 0.0, 0.0] for c in cxs], np.float32)
    plan = sweep_march.translation_plan(
        w, h, w, h, f1 * 0.06 * izmin + 1.25, 0.0
    )
    kw = dict(plan=plan, num_planes=K, raw=True, offset=(0.25, 0.0),
              crop_y=4, mask_mode="none")
    got = render_translation_batch_pallas(
        rgb, disp, mask, izmin, izmax, jnp.asarray(c1_b), f1,
        jnp.asarray(tabs), jnp.zeros(4), **kw,
    )
    for i in range(len(cxs)):
        want = sweep_march.render_translation_xla(
            rgb, disp, mask, izmin, izmax, jnp.asarray(c1_b[i]), f1,
            jnp.asarray(tabs[i]), jnp.zeros(4), **kw,
        )
        for g, r in zip(got, want):
            assert np.abs(np.asarray(g[i]) - np.asarray(r)).max() < 1e-4


def test_gpu_kernel_source_prep_checks_crop():
    """The kernel reads source rows 1:1 with output rows: a taller
    source must be center-cropped by the caller first."""
    plan = sweep_march.translation_plan(128, 40, 128, 32, 10.0, 0.0)
    z = jnp.zeros((40, 128))
    with pytest.raises(ValueError, match="center-crop"):
        prepare_lateral_source(jnp.zeros((40, 128, 3)), z, z, plan)


def test_march_dispatch_uses_twin_on_cpu(rng, monkeypatch):
    """On the CPU backend the dispatchers run the XLA twin and prepare no
    kernel source; forcing the kernel choice routes through it."""
    from lif_tpu import backend

    h, w = 16, 128
    rgb, disp, mask = _kernel_case(rng, h, w)
    plan = sweep_march.translation_plan(w, h, w, h, 8.0, 0.0)
    prep = sweep_march.prepare_translation_source(rgb, disp, mask, plan)
    assert prep is None
    plane = jnp.linspace(1.9, 0.11, 8)
    args = (rgb, disp, mask, 2.0, 0.1, jnp.asarray([0.04, 0.0, 0.0]),
            0.78 * w, plane, jnp.zeros(4))
    twin = np.asarray(sweep_march.render_translation(
        *args, plan=plan, num_planes=8))
    calls = []
    import lif_tpu.ops.sweep_march_gpu as gpu

    orig = gpu.render_translation_batch_gpu
    monkeypatch.setattr(backend, "march_impl", lambda platform=None: "triton")
    monkeypatch.setattr(
        gpu, "render_translation_batch_gpu",
        lambda *a, **kw: (calls.append(1), orig(*a, interpret=True, **kw))[1],
    )
    kern = np.asarray(sweep_march.render_translation(
        *args, plan=plan, num_planes=8))
    assert calls == [1]
    assert np.abs(kern - twin).max() < 1e-4
