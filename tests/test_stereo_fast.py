"""Golden tests: the fast (plane-march) stereo path vs the march-exact
stereo kernel (ops/stereo, itself golden-tested against the float64
reference in test_stereo.py)."""

import numpy as np
import jax.numpy as jnp

from lif_tpu import (
    Camera,
    projector_from_arrays,
    render_stereo_fast,
    render_stereo_fast_batch,
    render_stereo_view,
)
from .scenes import make_layer


def _pair(rng, h, w, eye, with_mask=False):
    ll = make_layer(rng, h, w, with_mask=with_mask)
    lr = make_layer(rng, h, w, with_mask=with_mask)

    def proj(layer, x):
        extra = None
        if with_mask:
            extra = [dict(
                rgb=np.asarray(layer["rgb"], np.float32)[::-1].copy(),
                disp=np.asarray(layer["disp"], np.float32),
                mask=np.asarray(layer["mask"], np.float32),
                focal_px=layer["focal"],
                invz_min=layer["invz_min"] * 0.8,
                invz_max=layer["invz_max"],
            )]
        return projector_from_arrays(
            np.asarray(layer["rgb"], np.float32),
            np.asarray(layer["disp"], np.float32),
            focal_px=layer["focal"],
            invz_min=layer["invz_min"],
            invz_max=layer["invz_max"],
            baseline=1.0,
            position=(x, 0.0, 0.0),
            extra_layers=extra,
        )

    return proj(ll, -eye), proj(lr, eye)


def _psnr(a, b):
    mse = np.mean((np.asarray(a)[..., :3] - np.asarray(b)[..., :3]) ** 2)
    return 10 * np.log10(1.0 / max(float(mse), 1e-12))


def test_stereo_fast_matches_march_kernel(rng):
    """Single-layer maskless stereo: the fast path reproduces the exact
    two-view kernel (weight + occlusion fill + blend) at >= 37 dB."""
    h, w = 96, 128
    eye = 0.03
    left, right = _pair(rng, h, w, eye)
    cam = Camera.create(
        w, h, focal_px=0.78 * w, position=[0.01, 0.0, 0.0]
    )
    exact = render_stereo_view(left, right, cam, num_steps=160)
    fast = render_stereo_fast(left, right, cam, num_planes=160)
    p = _psnr(fast, exact)
    # bound: the ORACLE's 160-step march discretization (the fast path is
    # snap-exact; the march's step-halving quantizes crossings), plus
    # occlusion-fill rule sensitivity where the eyes' tapers differ
    assert p >= 37.0, f"only {p:.1f} dB vs the exact stereo kernel"


def test_stereo_fast_weight_extremes(rng):
    """At the left view position the blend is ~all-left AWAY from the
    feathering band (inside the band the occlusion fill legitimately
    substitutes right-view content where the left taper dips — the exact
    kernel does the same, rayCastStereoLDI.glsl:372-381)."""
    h, w = 64, 96
    eye = 0.04
    left, right = _pair(rng, h, w, eye)
    from lif_tpu.models.renderer import render_fast_view

    cam_l = Camera.create(w, h, focal_px=0.78 * w, position=[-eye, 0.0, 0.0])
    fast = np.asarray(render_stereo_fast(left, right, cam_l, num_planes=96))
    mono_l = np.asarray(
        render_fast_view(left, cam_l, num_planes=96, mask_mode="none")
    )
    # interior: feathering 0.1 -> skip a 15% border on every side
    bh, bw = int(0.15 * h), int(0.15 * w)
    p = _psnr(fast[bh:-bh, bw:-bw], mono_l[bh:-bh, bw:-bw])
    # bound: the occlusion fill substitutes right-view content wherever
    # the left alpha dips >0.1 below the right (interior mask/taper dips
    # included) — a rule divergence vs pure-left, not warp error
    assert p >= 35.0, f"left-eye pose should be ~pure left view ({p:.1f} dB)"


def test_stereo_fast_batch_matches_single(rng):
    """The batched stereo (one dispatch) equals per-pose fast stereo."""
    h, w = 64, 96
    eye = 0.03
    left, right = _pair(rng, h, w, eye)
    cams = [
        Camera.create(w, h, focal_px=0.78 * w, position=[x, 0.0, 0.0])
        for x in (-0.02, 0.0, 0.015)
    ]
    batched = np.asarray(
        render_stereo_fast_batch(left, right, cams, num_planes=64)
    )
    for i, cam in enumerate(cams):
        single = np.asarray(
            render_stereo_fast(left, right, cam, num_planes=64)
        )
        assert np.abs(batched[i] - single).max() < 1e-5, i


def test_stereo_fast_fused_postprocess(rng):
    """postprocess= runs inside the compiled stereo core (one dispatch,
    see render_fast_batch) and equals applying the function after."""
    import jax.numpy as jnp

    h, w = 64, 96
    left, right = _pair(rng, h, w, 0.03)
    cams = [
        Camera.create(w, h, focal_px=0.78 * w, position=[x, 0.0, 0.0])
        for x in (-0.02, 0.0, 0.015)
    ]

    def per_frame_sum(img):
        return jnp.sum(img, axis=(1, 2, 3))

    imgs = np.asarray(render_stereo_fast_batch(left, right, cams, num_planes=64))
    fused = np.asarray(
        render_stereo_fast_batch(
            left, right, cams, num_planes=64, postprocess=per_frame_sum
        )
    )
    np.testing.assert_allclose(fused, imgs.sum(axis=(1, 2, 3)), rtol=1e-5)


def test_stereo_fast_ldi_masked(rng):
    """2-layer LDI with masks: the dilated hard-discard semantics keep the
    fast path close to the exact stereo kernel (mask-edge flips excluded,
    like test_stereo's decisive-pixel rule)."""
    h, w = 96, 128
    eye = 0.03
    left, right = _pair(rng, h, w, eye, with_mask=True)
    cam = Camera.create(w, h, focal_px=0.78 * w, position=[0.005, 0.0, 0.0])
    exact = np.asarray(render_stereo_view(left, right, cam, num_steps=160))
    fast = np.asarray(render_stereo_fast(left, right, cam, num_planes=160))
    # exclude pixels where the binary discard flips between the pre-eroded
    # fast mask and the shader's per-sample test
    dis = (exact[..., 3] <= 1e-6) != (fast[..., 3] <= 1e-6)
    assert dis.mean() < 0.01, f"too many discard flips: {dis.mean():.3f}"
    keep = ~dis
    mse = np.mean((exact[..., :3][keep] - fast[..., :3][keep]) ** 2)
    p = 10 * np.log10(1.0 / max(float(mse), 1e-12))
    # the confidence-keyed occlusion fill (_stretch_conf — the
    # exact kernel's stretch-mark rule instead of the crossing flag)
    # lifted this from 30-class to 42.6 dB and zeroed the discard flips
    assert p >= 40.0, f"only {p:.1f} dB vs the exact stereo kernel (masked)"


def test_stereo_fast_outpainted_layers(rng):
    """Outpainted (larger-than-view) layers ride the fast stereo path:
    matches the exact stereo kernel like the matched-dims case."""
    h, w = 96, 128
    sh, sw = h + 16, w + 32
    ll = make_layer(rng, sh, sw)
    lr = make_layer(rng, sh, sw)
    eye = 0.03
    left = projector_from_arrays(
        np.asarray(ll["rgb"], np.float32), np.asarray(ll["disp"], np.float32),
        focal_px=0.78 * w, invz_min=ll["invz_min"], invz_max=ll["invz_max"],
        baseline=1.0, position=(-eye, 0.0, 0.0),
    )
    right = projector_from_arrays(
        np.asarray(lr["rgb"], np.float32), np.asarray(lr["disp"], np.float32),
        focal_px=0.78 * w, invz_min=lr["invz_min"], invz_max=lr["invz_max"],
        baseline=1.0, position=(eye, 0.0, 0.0),
    )
    cam = Camera.create(w, h, focal_px=0.78 * w, position=[0.01, 0.0, 0.0])
    exact = render_stereo_view(left, right, cam, num_steps=160)
    fast = render_stereo_fast(left, right, cam, num_planes=160)
    assert np.asarray(fast).shape == np.asarray(exact).shape
    p = _psnr(fast, exact)
    # bound: the 160-step oracle discretization plus border-semantics
    # divergence inside the outpaint margin (the march clamps reads to a
    # 2-texel interior of the FULL layer; the fast path edge-replicates)
    assert p >= 35.0, f"outpainted stereo fast only {p:.1f} dB"


def test_stereo_fast_rotated_pose(rng):
    """Rotated head pose: each eye routes through the two-phase rotated
    march tier; the blend lattice matches the exact two-view kernel —
    the reference's default full-rate arbitrary-pose stereo
    (rayCastStereoLDI.glsl:368-436)."""
    h, w = 96, 128
    eye = 0.03
    left, right = _pair(rng, h, w, eye)
    t = 0.06
    rot = np.array(
        [[np.cos(t), 0, np.sin(t)], [0, 1, 0], [-np.sin(t), 0, np.cos(t)]]
    )
    cam = Camera.create(
        w, h, focal_px=0.78 * w, position=[0.01, 0.0, 0.0], rotation=rot
    )
    fast = render_stereo_fast(left, right, cam)
    exact = render_stereo_view(left, right, cam, num_steps=320)
    p = _psnr(fast[8:-8, 8:-8], exact[8:-8, 8:-8])
    assert p > 40.0, f"rotated stereo fast only {p:.1f} dB"


def test_stereo_fast_offaxis_translation(rng):
    """y/z-translated head pose (the head moving off the stereo rig's
    baseline axis): the scaled-march tier replaces the former
    ValueError; golden vs the exact two-view kernel."""
    h, w = 96, 128
    eye = 0.03
    left, right = _pair(rng, h, w, eye)
    cam = Camera.create(
        w, h, focal_px=0.78 * w, position=[0.015, 0.02, 0.03]
    )
    fast = render_stereo_fast(left, right, cam)
    exact = render_stereo_view(left, right, cam, num_steps=320)
    p = _psnr(fast[8:-8, 8:-8], exact[8:-8, 8:-8])
    assert p > 40.0, f"off-axis stereo fast only {p:.1f} dB"
