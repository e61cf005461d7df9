"""End-to-end example: the seeded flagship scene -> novel views.

The analog of the reference demo's default scene bootstrap (reference:
index.html:110-170 scene constants, 1280x800). The scene is generated
from a seed (lif_tpu.io.synthetic) with the demo's constants, authored
as a LIF container in memory, loaded through the public API, and
rendered at an identity view, a translated novel view, an orbit view and
an extreme far view; PNGs are saved and the run self-checks:

  1. identity pose reproduces the authored image (center crop > 45 dB)
  2. novel view shows parallax (finite, covered, differs from identity)
  3. extreme pose (100 m away) yields zero coverage and no NaNs

Usage (from the repository root; needs Pillow for the LIF container):
  python examples/render_sfmoma.py --out out_dir [--mode fast|raycast]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def sfmoma_assets(small: bool = False, scale: int = 1, seed: int = 0):
    """The flagship scene encoded as the demo's assets: (sRGB JPEG bytes,
    8-bit inverse-depth PNG bytes, w, h). `scale` divides both sides
    (small=True is scale 4, for quick CPU runs; scale 2 gives 640x400 —
    still 128-divisible, so the rotated target-ray tier stays eligible)."""
    from lif_tpu.io.decode import encode_jpeg, encode_png
    from lif_tpu.io.synthetic import flagship_scene

    scene = flagship_scene(seed, 4 if small else scale)
    h, w = scene.disp.shape
    return encode_jpeg(scene.rgb, quality=95), encode_png(scene.disp), w, h


def build_sfmoma_lif(position=(0, 0, 0), small: bool = False,
                     scale: int = 1, seed: int = 0) -> bytes:
    """Author the flagship scene as an in-memory LIF container with the
    demo's constants (reference: index.html:142-168)."""
    from lif_tpu.io import container

    jpeg, depth, w, h = sfmoma_assets(small, scale, seed)
    meta = {
        "views": [{
            "image": {"blob_id": -1},
            "inv_z_map": {"blob_id": 20, "min": 0.09, "max": 0.0001},
            "width_px": w, "height_px": h, "focal_px": 0.78 * w,
            "position": list(position), "rotation": [0, 0, 0],
        }],
        "baseline_mm": 45.0,
        "stereo_render_data": {"invd": 0.045},
    }
    return container.write(jpeg, meta, {20: depth})


def save_png(img, path):
    from PIL import Image

    arr = np.asarray(img)[::-1]  # GL orientation -> top-down
    Image.fromarray(
        (np.clip(arr[..., :3], 0.0, 1.0) * 255).astype(np.uint8)
    ).save(path)


def psnr(a, b):
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else 10.0 * np.log10(1.0 / mse)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="render_out")
    ap.add_argument("--mode", default="raycast", choices=["fast", "raycast"])
    ap.add_argument("--frames", type=int, default=0,
                    help="also render an N-frame orbit trajectory")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    import jax
    import jax.numpy as jnp

    from lif_tpu import Camera, load_lif_file, render

    print("devices:", jax.devices())
    result = load_lif_file(build_sfmoma_lif())
    proj = result.projectors[0].to_device()
    w = int(proj.layer_res[0, 0])
    h = int(proj.layer_res[0, 1])
    focal = float(proj.focal[0])
    baseline = float(proj.baseline)
    kwargs = {} if args.mode == "fast" else {"mask_mode": "none"}

    def cam(pos, rot=None):
        return Camera.create(w, h, focal_px=focal, position=pos, rotation=rot)

    def sync(img):
        _ = float(jnp.sum(img))
        return img

    report = {"mode": args.mode}

    # 1. identity passthrough
    t0 = time.time()
    img_id = sync(render(proj, cam([0.0, 0.0, 0.0]), mode=args.mode, **kwargs))
    print(f"identity render (incl compile): {time.time() - t0:.1f}s")
    save_png(img_id, os.path.join(args.out, "identity.png"))
    from lif_tpu.io.decode import decode_rgb

    # the authored (JPEG-decoded) image, display-encoded like the render
    ref = np.asarray(decode_rgb(sfmoma_assets()[0], linear=False))
    crop = (slice(160, -160), slice(160, -160))
    p = psnr(np.asarray(img_id)[crop][..., :3], ref[crop])
    report["identity_psnr_dB"] = round(p, 2)
    assert p > 45.0, f"identity passthrough only {p:.1f} dB"

    # 2. novel view: 3 baselines right
    t0 = time.time()
    img_nv = sync(render(proj, cam([3 * baseline, 0.0, 0.0]),
                         mode=args.mode, **kwargs))
    dt = time.time() - t0
    save_png(img_nv, os.path.join(args.out, "novel_right.png"))
    nv = np.asarray(img_nv)
    assert np.all(np.isfinite(nv)), "novel view has non-finite values"
    cov = float(np.mean(nv[..., 3]))
    shift = float(np.mean(np.abs(nv[..., :3] - np.asarray(img_id)[..., :3])))
    report["novel_coverage"] = round(cov, 3)
    report["novel_mean_abs_diff"] = round(shift, 4)
    report["novel_render_s"] = round(dt, 3)
    assert 0.5 < cov <= 1.0, f"novel-view alpha coverage {cov}"
    assert shift > 0.01, f"no parallax: mean abs diff {shift}"

    # 3. extreme pose: 100 m away -> nothing visible, no NaNs
    img_far = sync(render(proj, cam([100.0, 0.0, 0.0]), mode=args.mode, **kwargs))
    far = np.asarray(img_far)
    assert np.all(np.isfinite(far)), "extreme pose has non-finite values"
    report["far_coverage"] = round(float(np.mean(far[..., 3])), 4)
    assert float(np.mean(far[..., 3])) < 0.01, "extreme pose should be empty"

    # 4. production fast path agrees with the exact march at the novel
    # pose (the snap-plane march's fidelity gate, end-to-end through the
    # public API)
    if args.mode == "raycast":
        img_fast = sync(render(proj, cam([3 * baseline, 0.0, 0.0]),
                               mode="fast"))
        save_png(img_fast, os.path.join(args.out, "novel_right_fast.png"))
        pf = psnr(np.asarray(img_fast)[crop][..., :3], nv[crop][..., :3])
        report["fast_vs_march_psnr_dB"] = round(pf, 2)
        assert pf > 30.0, (
            f"fast path only {pf:.1f} dB vs the march at the novel pose "
            "(the march's own discretization noise floor is ~34 dB; "
            "below 30 means a real regression)"
        )

    # optional orbit
    if args.frames:
        from lif_tpu import orbit_pose

        frames_dir = os.path.join(args.out, "frames")
        os.makedirs(frames_dir, exist_ok=True)
        for i, t in enumerate(np.linspace(-10, 10, args.frames)):
            pos, rot = orbit_pose(result.orbit_center, 1.0, theta=np.deg2rad(t))
            img = sync(render(proj, cam(pos, rot), mode=args.mode, **kwargs))
            save_png(img, os.path.join(frames_dir, f"orbit_{i:03d}.png"))
        report["orbit_frames"] = args.frames

    print(json.dumps(report))
    print("PASS")
    return 0


if __name__ == "__main__":
    sys.exit(main())
