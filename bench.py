"""Benchmark: novel-view rendering throughput on one GPU.

Prints ONE JSON line as its last line:
  {"metric": ..., "value": N, "unit": "frames/sec", "device": {...}}

Workload: the seeded flagship scene (lif_tpu.io.synthetic, 1280x800 RGB +
inverse depth, single projector) rendered at lateral novel poses —
BASELINE.json configs[0] — through the production entry point
render_fast_batch(method="march"): the integer-parallax snap-plane march
(ops/sweep_march.snap_plane_table), which on a GPU runs the Pallas
(Triton) kernel of ops/sweep_march_gpu.py. A second number renders the
same frame count split 1/3 lateral + 1/3 orbit (target tier) + 1/3 zoom
(scaled tier), each family one dispatch through its own tier.

Fidelity is measured in this run: the PSNR of the benched mode against
the converged 640-step ray march at the bench pose, beside the
reference's own 40-step march.

Protocol: inputs device-resident; each pass is one render_fast_batch
dispatch whose frames reduce to a device scalar inside the same program
(postprocess=); one host sync per pass; the reported figure is the
median of 5 passes after a warm-up pass. Needs a GPU.

  python bench.py
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

W, H = 1280, 800
# a multiple of config.pose_chunk (48): the pose-chunked lax.map pads the
# tail chunk, so a non-multiple would bill padding frames as work
BATCH = 432


def _psnr(a, b):
    mse = np.mean((np.asarray(a)[..., :3] - np.asarray(b)[..., :3]) ** 2)
    return 10 * np.log10(1.0 / max(float(mse), 1e-12))


def _median_fps(step, frames, passes):
    float(step())  # compile + warm-up
    rates = []
    for _ in range(passes):
        t0 = time.perf_counter()
        float(step())
        rates.append(frames / (time.perf_counter() - t0))
    return float(np.median(rates))


def main():
    import jax
    import jax.numpy as jnp

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py needs a GPU (default device: {dev.platform})")

    from lif_tpu import Camera, backend, orbit_pose
    from lif_tpu.io.synthetic import flagship_orbit_center, flagship_projector
    from lif_tpu.models.renderer import render_fast_batch, render_mono_view

    backend.configure_compile_cache()
    proj = flagship_projector(seed=0).to_device()
    center = flagship_orbit_center(proj)
    focal = float(proj.focal[0])

    def cam(x):
        return Camera.create(W, H, focal_px=focal, position=[x, 0.0, 0.0])

    def reduce_img(img):
        return jnp.sum(img) * 1e-9

    # the march plan's window is the union of the batch's shifts, so the
    # spread (not the count) sets the per-tile footprint
    lat = [cam(0.135 + 0.02 * i / BATCH) for i in range(BATCH)]
    fps = _median_fps(
        lambda: render_fast_batch(proj, lat, method="march",
                                  postprocess=reduce_img),
        BATCH, 5,
    )

    third = BATCH // 3
    families = [
        lat[::3][:third],
        [Camera.create(W, H, focal_px=focal, position=p, rotation=r)
         for p, r in (orbit_pose(center, 1.0, theta=np.deg2rad(t))
                      for t in np.linspace(-15, 15, third))],
        [Camera.create(W, H, focal_px=focal,
                       position=[0.0, 0.0, 0.1 + 0.1 * i / third])
         for i in range(third)],
    ]

    def composite():
        return jnp.sum(jnp.stack([
            render_fast_batch(proj, cs, method="auto",
                              postprocess=reduce_img)
            for cs in families
        ]))

    composite_fps = _median_fps(composite, 3 * third, 3)

    cam0 = cam(0.135)
    bench_img = render_fast_batch(proj, [cam0], method="march")[0]
    conv = render_mono_view(proj, cam0, mask_mode="none", num_steps=640)
    ref40 = render_mono_view(proj, cam0, mask_mode="none", num_steps=40)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    print(json.dumps({
        "metric": (
            f"novel-view frames/sec @{W}x{H}, median of 5 passes of one "
            f"{BATCH}-pose render_fast_batch dispatch (seeded flagship "
            "scene, snap-plane march; measured this run: "
            f"{_psnr(bench_img, conv):.1f} dB vs the converged 640-step "
            "march at the bench pose, where the reference's 40-step march "
            f"measures {_psnr(ref40, conv):.1f} dB; mixed-family composite "
            f"1/3 lateral + 1/3 orbit + 1/3 zoom: {composite_fps:.1f} fps)"
        ),
        "value": round(fps, 3),
        "unit": "frames/sec",
        "composite_fps": round(composite_fps, 3),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices()), "card": card},
    }))


if __name__ == "__main__":
    main()
