"""Golden tests for the SCALED first-crossing march.

Oracle chain: ops/raycast (golden vs the float64 reference renderer) ->
sweep_scaled XLA implementation (this file: >=40 dB vs the high-step
march on dolly / diagonal / zoom poses, and against the float64
reference shader directly).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from lif_tpu.ops import raycast, sweep_scaled
from tests.test_sweep_march import _march, _psnr, _scene


def _setup(rng, c1, fr=1.0, h=96, w=128, step_px=0.75):
    rgb, disp, mask = _scene(rng, h=h, w=w)
    izmin, izmax = 2.0, 0.1
    f1 = 0.78 * w
    plan = sweep_scaled.scaled_plan(
        w, h, w, h, f1, fr,
        abs(c1[0]), abs(c1[1]), min(c1[2], 0.0), max(c1[2], 0.0),
        izmin, izmax,
    )
    grid, k = sweep_scaled.parallax_step_grid(
        f1, c1, fr, w, h, izmin, izmax, step_px=step_px
    )
    return rgb, disp, mask, izmin, izmax, f1, plan, grid, k


@pytest.mark.parametrize(
    "c1,fr,name",
    [
        ([0.05, 0.0, 0.0], 1.0, "lateral"),
        ([0.03, 0.0, 0.04], 1.0, "dolly"),
        ([0.04, 0.02, 0.0], 1.0, "diagonal"),
        ([0.02, 0.01, 0.03], 1.0, "general"),
        ([0.03, 0.0, 0.0], 1.08, "zoom"),
    ],
)
def test_scaled_oracle_matches_converged_march(rng, c1, fr, name):
    """The separable-affine candidate sweep reproduces the exact ray
    march for translation + scale pose families (the reference shader
    handles these in one kernel, rayCastMonoLDI.glsl:249; here they are
    the scaled march's warp family)."""
    rgb, disp, mask, izmin, izmax, f1, plan, grid, k = _setup(rng, c1, fr)
    h, w = disp.shape
    out = np.asarray(
        sweep_scaled.render_scaled_xla(
            rgb, disp, mask, izmin, izmax, jnp.asarray(c1, jnp.float32),
            f1, fr, grid, jnp.zeros(4), plan, k,
            mask_mode="none", to_srgb=True, refine=2,
        )
    )
    ref = _march(rgb, disp, mask, izmin, izmax, f1, c1, w, h, steps=480,
                 f2=f1 / fr)
    sl = np.s_[10:-10, 10:-10]
    p = _psnr(out[sl], ref[sl])
    assert p > 40.0, f"{name}: scaled oracle only {p:.1f} dB"


def test_depth_only_matches_full(rng):
    """depth_only returns the same found/invz* as the full render path
    (pass 2's color work must not feed back into the depth solve)."""
    c1 = [0.03, 0.01, 0.03]
    rgb, disp, mask, izmin, izmax, f1, plan, grid, k = _setup(rng, c1)
    found, izs = sweep_scaled.render_scaled_xla(
        rgb, disp, mask, izmin, izmax, jnp.asarray(c1, jnp.float32),
        f1, 1.0, grid, jnp.zeros(4), plan, k,
        mask_mode="none", depth_only=True,
    )
    _, _, hit, izs_full = sweep_scaled.render_scaled_xla(
        rgb, disp, mask, izmin, izmax, jnp.asarray(c1, jnp.float32),
        f1, 1.0, grid, jnp.zeros(4), plan, k,
        mask_mode="none", raw=True,
    )
    assert np.allclose(np.asarray(izs), np.asarray(izs_full), atol=1e-6)


def test_batch_matches_per_pose(rng):
    """The batched dispatch equals per-pose renders (CPU vmap path)."""
    c1s = np.array(
        [[0.03, 0.0, 0.02], [0.05, 0.01, 0.0], [0.0, 0.02, 0.03]],
        np.float32,
    )
    rgb, disp, mask, izmin, izmax, f1, plan, grid, k = _setup(
        rng, [0.05, 0.02, 0.03]
    )
    grids, k = sweep_scaled.parallax_step_grids_batch(
        f1, c1s, 1.0, disp.shape[1], disp.shape[0], izmin, izmax
    )
    batch = np.asarray(
        sweep_scaled.render_scaled_batch(
            rgb, disp, mask, izmin, izmax, c1s, f1, 1.0, grids,
            jnp.zeros(4), plan, k, mask_mode="none",
        )
    )
    for i, c1 in enumerate(c1s):
        single = np.asarray(
            sweep_scaled.render_scaled(
                rgb, disp, mask, izmin, izmax, c1, f1, 1.0, grids[i],
                jnp.zeros(4), plan, k, mask_mode="none",
            )
        )
        assert np.allclose(batch[i], single, atol=1e-6)


def test_heavily_outpainted_layer_scaled_path(rng):
    """A source much TALLER than the scaled window's reach (big outpaint
    margins) must still plan and render: ScaledPlan.padded_h used to be
    window-reach only, so _pad_stack's top pad went NEGATIVE and jnp.pad
    raised at trace time instead of rendering.
    The extra rows sit beyond every window's displacement clip, so
    fidelity is unchanged — golden vs the exact march."""
    from lif_tpu import Camera, projector_from_arrays
    from lif_tpu.models.renderer import render_fast_view, render_mono_view

    oh, ow = 96, 128
    sh, sw = oh + 2 * 192, ow + 2 * 192  # 512x480 source
    rgb, disp, mask = _scene(rng, h=sh, w=sw)
    proj = projector_from_arrays(
        rgb, disp, focal_px=0.78 * ow, invz_min=2.0, invz_max=0.1,
        baseline=1.0,
    )
    plan = sweep_scaled.scaled_plan(
        sw, sh, ow, oh, 0.78 * ow, 1.0, 0.02, 0.01, 0.0, 0.0, 2.0, 0.1
    )
    assert plan.padded_h >= plan.ky_lo * 128 + sh  # the fix
    cam = Camera.create(ow, oh, focal_px=0.78 * ow,
                        position=[0.02, 0.01, 0.0])  # diagonal: scaled tier
    fast = np.asarray(render_fast_view(proj, cam, mask_mode="none"))
    ref = np.asarray(render_mono_view(proj, cam, mask_mode="none",
                                      num_steps=320))
    assert np.isfinite(fast).all()
    sl = np.s_[10:-10, 10:-10]
    p = _psnr(fast[sl], ref[sl])
    assert p > 40.0, f"outpainted scaled path only {p:.1f} dB"


def reference64(rgb, disp, mask, izmin, izmax, f1, c1, rot1, w, h,
                f2=None, steps=320):
    """The float64 transliteration of the reference shader
    (tests/reference_renderer.py) at `steps` march steps: an oracle
    independent of every JAX code path."""
    from tests import reference_renderer as ref

    layer = dict(
        rgb=np.asarray(rgb, np.float64), disp=np.asarray(disp, np.float64),
        mask=np.asarray(mask, np.float64), res=(w, h), invz_min=izmin,
        invz_max=izmax, focal=f1,
    )
    saved = ref.NUM_STEPS
    ref.NUM_STEPS = steps
    try:
        return ref.render_mono_reference(
            [layer], np.zeros(2), np.asarray(c1, np.float64),
            np.asarray(rot1, np.float64), f1 if f2 is None else f2,
            np.zeros(2), w, h, mask_mode="none",
        )
    finally:
        ref.NUM_STEPS = saved


@pytest.mark.parametrize(
    "c1,depth_only",
    [
        ([0.03, 0.01, 0.02], False),
        ([0.05, 0.0, 0.0], False),
        ([0.04, 0.01, 0.03], True),
    ],
)
def test_twin_matches_float64_reference(rng, c1, depth_only):
    """The scaled-march twin on the cases its tiled kernel was checked
    on, against the float64 reference shader: the full-colour bracket
    lerp, and the depth-only solve through the production colour fetch."""
    c1 = np.asarray(c1, np.float32)
    rgb, disp, mask, izmin, izmax, f1, plan, grid, k = _setup(
        rng, c1, h=128, w=64
    )
    h, w = disp.shape
    if depth_only:
        out = np.asarray(sweep_scaled.render_scaled_fetch_batch(
            rgb, disp, mask, izmin, izmax, c1[None], f1, 1.0, grid,
            jnp.zeros(4), plan, k, mask_mode="none",
        ))[0]
    else:
        out = np.asarray(sweep_scaled.render_scaled_xla(
            rgb, disp, mask, izmin, izmax, c1, f1, 1.0, grid,
            jnp.zeros(4), plan, k, mask_mode="none", refine=2,
        ))
    want = reference64(rgb, disp, mask, izmin, izmax, f1, c1, np.eye(3),
                       w, h)
    sl = np.s_[10:-10, 10:-10]
    assert _psnr(out[sl], want[sl]) > 38.0
