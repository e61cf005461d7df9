"""Smoke run of the render path on one NVIDIA GPU (or four, with --four).

Drives the renderer through the entry points a user calls, at the full
1280x800 size of the seeded flagship scene (lif_tpu.io.synthetic), with
every kernel compiled for the card (none in interpret mode), and checks
the output of every phase:

  device   the default device is a GPU; its name and power limit
  exact    render(mode="raycast"): identity passthrough > 45 dB on the
           centre crop, a novel view 3 baselines right (finite, coverage
           in (0.5, 1], mean |diff| vs identity > 0.01), a pose 100 m away
           (no coverage, no NaN)
  fast     render_fast_batch per pose family, asserting the routed tier
           and the PSNR of its edge pose against the 640-step march
           (rolled), held to the bound of the family's CPU golden test
  stereo / fused / mesh / billboard
           the stereo and fused fast cores against their references,
           one mesh frame, one billboard batch
  parity   the lateral GPU kernel vs its XLA twin on the card, and the
           twin on the card vs the same jitted twin on the host CPU;
           then render_fast_batch(method="march") at 48 poses timed
           end to end with the kernel and with the twin, in turns

Tolerances. Parity: PSNR >= 60 dB and at most 0.1% of pixels off by more
than 1e-3 (crossing flips at FMA and summation-order boundaries). Fidelity
bounds are the CPU goldens': lateral 40 dB (test_sweep_march), scaled
40 dB (test_sweep_scaled), yaw orbit 38 dB (test_flagship_orbit),
elevation 40 dB (test_pitch_transpose), rotated 33 dB
(test_pitch_transpose), stereo 37 dB (test_stereo_fast), fused batch vs
per-frame by the parity rule. Precision: every 3x3 product is explicitly
HIGHEST (core/transforms.py, train/fit.py); nothing else in the render
path is a matrix product, so TF32 never applies.

Each phase prints its numbers on one line: frames/s (median of 3 timed
passes after a warm-up, one host sync per pass), compile seconds (first
call minus a timed pass), and peak device bytes so far. The card's name
and power limit are printed before the last line, which is one JSON
object {"ok": true, "device": {...}}. Any failed check raises, so the
script exits non-zero without that line. With no GPU it exits 2.

  python chip_smoke.py            # one card, every phase
  python chip_smoke.py --four     # four cards: the sharded phases only
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

SEED = 0
PARITY_DB, PARITY_FRAC = 60.0, 1e-3


def _card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()


def _psnr(a, b, sl=np.s_[...]):
    a = np.asarray(a, np.float64)[sl][..., :3]
    b = np.asarray(b, np.float64)[sl][..., :3]
    mse = float(np.mean((a - b) ** 2))
    return 10.0 * np.log10(1.0 / max(mse, 1e-20))


def _check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def _parity(name, got, want):
    """The parity rule: PSNR >= 60 dB, <= 0.1% of pixels off by > 1e-3."""
    got, want = np.asarray(got), np.asarray(want)
    _check(got.shape == want.shape, f"{name}: {got.shape} vs {want.shape}")
    p = _psnr(got, want)
    off = float((np.abs(got - want).max(-1) > 1e-3).mean())
    _check(np.isfinite(got).all(), f"{name}: non-finite output")
    _check(p >= PARITY_DB and off <= PARITY_FRAC,
           f"{name}: {p:.2f} dB, {off:.5f} of pixels off by > 1e-3")
    return {"psnr_db": round(p, 2), "frac_off": off}


def _peak(dev):
    return int(dev.memory_stats()["peak_bytes_in_use"])


def _devices_used(devices):
    """How many of `devices` have held arrays: each shard of a sharded
    call leaves a nonzero peak on its own card."""
    return sum(_peak(d) > 0 for d in devices)


def _timed(fn, n_frames):
    """(fps, compile_s): fn() must return a device scalar; one host sync
    per pass; median of 3 passes after the warm-up call."""
    t0 = time.perf_counter()
    float(fn())
    first = time.perf_counter() - t0
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        float(fn())
        ts.append(time.perf_counter() - t0)
    med = float(np.median(ts))
    return n_frames / med, max(first - med, 0.0)


def _report(phase, **kw):
    print(f"phase={phase} " + " ".join(f"{k}={v}" for k, v in kw.items()),
          flush=True)


def _reduce(img):
    import jax.numpy as jnp

    return jnp.sum(img) * 1e-9


def phase_exact(proj, scene, dev):
    from lif_tpu import Camera, render
    from lif_tpu.core.color import linear_to_srgb

    w, h, f = proj.width, proj.height, float(proj.focal[0])

    def cam(x):
        return Camera.create(w, h, focal_px=f, position=[x, 0.0, 0.0])

    t0 = time.perf_counter()
    ident = np.asarray(render(proj, cam(0.0), mode="raycast"))
    first = time.perf_counter() - t0
    crop = np.s_[160:-160, 160:-160]
    want = np.asarray(linear_to_srgb(scene.rgb))
    p_id = _psnr(ident, want, crop)
    _check(p_id > 45.0, f"identity passthrough only {p_id:.2f} dB")
    novel = np.asarray(render(proj, cam(3 * float(proj.baseline)),
                              mode="raycast"))
    _check(np.isfinite(novel).all(), "novel view has non-finite values")
    cov = float(novel[..., 3].mean())
    shift = float(np.abs(novel[..., :3] - ident[..., :3]).mean())
    _check(0.5 < cov <= 1.0, f"novel-view coverage {cov}")
    _check(shift > 0.01, f"no parallax: mean abs diff {shift}")
    far = np.asarray(render(proj, cam(100.0), mode="raycast"))
    _check(np.isfinite(far).all(), "100 m pose has non-finite values")
    far_cov = float(far[..., 3].mean())
    _check(far_cov < 1e-4, f"100 m pose coverage {far_cov}")
    fps, _ = _timed(lambda: _reduce(render(proj, cam(0.135),
                                           mode="raycast")), 1)
    _report("exact", identity_psnr_db=round(p_id, 2),
            novel_coverage=round(cov, 4), novel_mean_abs_diff=round(shift, 4),
            far_coverage=far_cov, fps_40step=round(fps, 2),
            first_call_s=round(first, 2), peak_bytes=_peak(dev))


def fast_families(proj, center):
    """(name, cameras, edge index, expected tier, PSNR bound) per family."""
    from lif_tpu import Camera, orbit_pose

    w, h, f = proj.width, proj.height, float(proj.focal[0])

    def cam(p, r=None):
        return Camera.create(w, h, focal_px=f, position=p, rotation=r)

    n = 48
    lateral = [cam([0.135 + 0.02 * i / n, 0.0, 0.0]) for i in range(n)]
    orbit = [cam(*orbit_pose(center, 1.0, theta=np.deg2rad(t)))
             for t in np.linspace(-15.0, 15.0, 24)]
    elev = [cam(*orbit_pose(center, 1.0, theta=0.0, phi=np.deg2rad(t)))
            for t in np.linspace(12.0, 2.0, 12)]
    zoom = [cam([0.0, 0.0, 0.2 - 0.1 * i / 24]) for i in range(24)]
    combined = [cam(*orbit_pose(center, 1.0, theta=np.deg2rad(t),
                                phi=np.deg2rad(t)))
                for t in (3.0, 2.5, 2.0, 1.5)]
    return [
        ("lateral", lateral, n - 1, "march", 40.0),
        ("orbit", orbit, 0, "target", 38.0),
        ("elevation", elev, 0, "target", 40.0),
        ("zoom", zoom, 0, "scaled", 40.0),
        ("yaw_pitch", combined, 0, "rotated", 33.0),
    ]


def phase_fast(proj, center, dev):
    from lif_tpu import render
    from lif_tpu.models.renderer import render_fast_batch

    for name, cams, edge, tier, bound in fast_families(proj, center):
        method = "march" if tier == "march" else "auto"
        out, tiers = render_fast_batch(proj, cams, method=method,
                                       return_tiers=True)
        _check(tiers == (tier,), f"{name} routed {tiers}, expected {tier}")
        out = np.asarray(out)
        _check(np.isfinite(out).all(), f"{name}: non-finite output")
        ref = render(proj, cams[edge], mode="raycast", num_steps=640)
        p = _psnr(out[edge], ref)
        _check(p >= bound, f"{name}: edge pose {p:.2f} dB < {bound}")
        del out
        fps, comp = _timed(
            lambda: render_fast_batch(proj, cams, method=method,
                                      postprocess=_reduce), len(cams))
        _report(f"fast_{name}", tier=tier, frames=len(cams),
                psnr_edge_vs_640_db=round(p, 2), bound_db=bound,
                fps=round(fps, 2), compile_s=round(comp, 2),
                peak_bytes=_peak(dev))


def build_fused(base, w=3840, h=2160, n=4):
    """BASELINE configs[4]: n coherent projectors (each synthesized at
    its own pose from the base view), resampled to w x h."""
    from lif_tpu import synthesize_projector
    from lif_tpu.models.projector import resample_projector

    scale = w / base.width
    return [
        resample_projector(
            synthesize_projector(base, [0.02 * i, 0.0, 0.0]), scale,
            out_w=w, out_h=h,
        ).to_device()
        for i in range(n)
    ]


def phase_stereo_fused_mesh_billboard(proj, dev, fused_size=(3840, 2160)):
    from lif_tpu import Camera, render, synthesize_projector
    from lif_tpu.io.synthetic import flagship_projector
    from lif_tpu.models.renderer import (
        render_billboard_fast_batch,
        render_fused_fast,
        render_fused_fast_batch,
        render_stereo_fast_batch,
        render_stereo_view,
    )

    w, h, f = proj.width, proj.height, float(proj.focal[0])
    b = float(proj.baseline)
    left = flagship_projector(SEED, position=(-b / 2, 0.0, 0.0))
    right = synthesize_projector(left, [b / 2, 0.0, 0.0])
    left, right = left.to_device(), right.to_device()
    cam = Camera.create(w, h, focal_px=f, position=[0.004, 0.0, 0.0])
    fast = np.asarray(render_stereo_fast_batch(left, right, [cam]))[0]
    exact = np.asarray(render_stereo_view(left, right, cam, num_steps=640))
    p = _psnr(fast, exact)
    _check(p >= 37.0, f"stereo fast vs exact only {p:.2f} dB")
    pairs = []
    for i in range(16):
        for x in (-b / 2, b / 2):
            pairs.append(Camera.create(w, h, focal_px=f,
                                       position=[x + 0.0005 * i, 0.0, 0.0]))
    fps, comp = _timed(lambda: render_stereo_fast_batch(
        left, right, pairs, postprocess=_reduce), len(pairs))
    _report("stereo", psnr_vs_exact_db=round(p, 2), bound_db=37.0,
            eye_frames=len(pairs), fps=round(fps, 2),
            compile_s=round(comp, 2), peak_bytes=_peak(dev))
    del left, right

    projs = build_fused(proj, *fused_size)
    w4, h4, f4 = projs[0].width, projs[0].height, float(projs[0].focal[0])
    cams4 = [Camera.create(w4, h4, focal_px=f4,
                           position=[0.05 + 0.002 * j, 0.0, 0.0])
             for j in range(4)]
    batch = np.asarray(render_fused_fast_batch(projs, cams4))
    par = [_parity(f"fused frame {j}", batch[j],
                   render_fused_fast(projs, c)) for j, c in enumerate(cams4)]
    del batch
    fps, comp = _timed(lambda: render_fused_fast_batch(
        projs, cams4, postprocess=_reduce), len(cams4))
    _report("fused_4k", size=f"{w4}x{h4}", projectors=len(projs),
            batch_vs_per_frame_min_psnr_db=min(q["psnr_db"] for q in par),
            fps=round(fps, 2), compile_s=round(comp, 2),
            peak_bytes=_peak(dev))
    del projs

    cam = Camera.create(w, h, focal_px=f, position=[0.135, 0.0, 0.0])
    t0 = time.perf_counter()
    mesh_img = np.asarray(render(proj, cam, mode="mesh"))
    t_mesh = time.perf_counter() - t0
    _check(np.isfinite(mesh_img).all(), "mesh frame has non-finite values")
    mcov = float(mesh_img[..., 3].mean())
    _check(mcov > 0.5, f"mesh frame coverage {mcov}")
    bb_cams = [Camera.create(w, h, focal_px=f, position=[x, 0.0, 0.0])
               for x in (0.1, 0.135)]
    bb = np.asarray(render_billboard_fast_batch(proj, bb_cams))
    for c, img in zip(bb_cams, bb):
        one = np.asarray(render(proj, c, mode="billboard"))
        _check(np.allclose(img, one, atol=1e-6), "billboard batch != frame")
    bcov = float(bb[..., 3].mean())
    _check(bcov > 0.5, f"billboard coverage {bcov}")
    _report("mesh_billboard", mesh_coverage=round(mcov, 4),
            mesh_first_call_s=round(t_mesh, 2),
            billboard_coverage=round(bcov, 4), peak_bytes=_peak(dev))


def _march_fps_with(impl, proj, cams):
    """(fps, compile_s) of render_fast_batch(method="march") with the
    lateral march forced to `impl` ('triton' kernel or 'xla' twin): the
    same planner and plane tables, only the implementation differs."""
    from lif_tpu import backend
    from lif_tpu.models import renderer as R

    chosen = backend.march_impl
    backend.march_impl = lambda platform=None: impl
    R._FAST_BATCH_CORE_CACHE.clear()  # the choice is made at trace time
    try:
        return _timed(lambda: R.render_fast_batch(
            proj, cams, method="march", postprocess=_reduce), len(cams))
    finally:
        backend.march_impl = chosen
        R._FAST_BATCH_CORE_CACHE.clear()


def phase_parity(proj, dev):
    import jax
    import jax.numpy as jnp

    from lif_tpu import Camera
    from lif_tpu.models import renderer as R
    from lif_tpu.ops import sweep_march
    from lif_tpu.ops.sweep_march_gpu import render_translation_batch_gpu

    lay = R._prepared_textures(proj)["layers"][0]
    cxs = [0.135 + 0.02 * i / 48 for i in range(48)]
    f = float(proj.focal[0])
    cams = [Camera.create(proj.width, proj.height, focal_px=f,
                          position=[c, 0.0, 0.0]) for c in cxs]
    e2e = {"triton": [], "xla": []}
    for impl in ("triton", "xla", "xla", "triton"):  # in turns
        e2e[impl].append(_march_fps_with(impl, proj, cams))
    plan, tabs, k = R._march_plan_tables(lay, cxs, proj.width, proj.height)
    c1 = jnp.asarray([[c, 0.0, 0.0] for c in cxs], jnp.float32)
    args = (lay["rgb"], lay["disp"], lay["mask"], lay["izmin"],
            lay["izmax"])
    bg = jnp.zeros(4, jnp.float32)

    def kernel():
        return render_translation_batch_gpu(
            *args, c1, lay["focal"], tabs, bg, plan, k)

    twin = jax.jit(jax.vmap(
        lambda cc, pp: sweep_march.render_translation_xla(
            *args, cc, lay["focal"], pp, bg, plan, k)))
    got, want = np.asarray(kernel()), np.asarray(twin(c1, tabs))
    par = [_parity(f"kernel vs twin pose {i}", got[i], want[i])
           for i in (0, 24, 47)]
    fps_k, comp_k = _timed(lambda: _reduce(kernel()), 48)
    fps_t, comp_t = _timed(lambda: _reduce(twin(c1, tabs)), 48)
    del got, want

    cpu = jax.devices("cpu")[0]
    one = [args[0], args[1], args[2], args[3], args[4], c1[47],
           lay["focal"], tabs[47], bg]
    on_gpu = sweep_march.render_translation_xla(*one, plan, k)
    on_cpu = sweep_march.render_translation_xla(
        *jax.device_put(one, cpu), plan, k)
    _check(next(iter(on_cpu.devices())).platform == "cpu", "not on cpu")
    host = _parity("twin gpu vs cpu", on_gpu, on_cpu)
    _report("parity", kernel_vs_twin_min_psnr_db=min(q["psnr_db"]
                                                      for q in par),
            kernel_vs_twin_max_frac_off=max(q["frac_off"] for q in par),
            twin_gpu_vs_cpu_psnr_db=host["psnr_db"],
            twin_gpu_vs_cpu_frac_off=host["frac_off"],
            kernel_fps=round(fps_k, 2), kernel_compile_s=round(comp_k, 2),
            twin_fps=round(fps_t, 2), twin_compile_s=round(comp_t, 2),
            poses=48, planes=k, peak_bytes=_peak(dev))

    def runs(impl, i):
        return "/".join(f"{r[i]:.2f}" for r in e2e[impl])

    _report("march_e2e", poses=48, kernel_fps=runs("triton", 0),
            kernel_compile_s=runs("triton", 1), twin_fps=runs("xla", 0),
            twin_compile_s=runs("xla", 1))


def phase_four(proj, center, devices, fused_size=(3840, 2160)):
    """The sharded deployments, each against its one-card reference:
    4-projector fusion over a ("view",) mesh, and a trajectory over a
    ("frame",) mesh."""
    import jax

    from lif_tpu import Camera, orbit_pose
    from lif_tpu.models.renderer import render_fast_batch, render_fused_fast
    from lif_tpu.parallel.sharding import (
        make_mesh,
        render_fast_trajectory_sharded,
        render_fused_projectors,
    )

    n = len(devices)
    projs = build_fused(proj, *fused_size, n=n)
    w4, h4, f4 = projs[0].width, projs[0].height, float(projs[0].focal[0])
    cam4 = Camera.create(w4, h4, focal_px=f4, position=[0.05, 0.0, 0.0])
    vmesh = make_mesh(("view",), (n,), devices=devices)
    t0 = time.perf_counter()
    sharded = np.asarray(render_fused_projectors(projs, cam4, vmesh,
                                                 num_steps=160))
    t_sh = time.perf_counter() - t0
    used = _devices_used(devices)
    _check(used == n, f"fusion ran on {used} of {n} devices")
    one = np.asarray(jax.device_get(render_fused_fast(projs, cam4)))
    sl = np.s_[3 * h4 // 16: -3 * h4 // 16, w4 // 6: -w4 // 6]
    p = _psnr(sharded, one, sl)
    _check(p > 30.0, f"sharded fusion vs one card only {p:.2f} dB")
    _report("four_fused", size=f"{w4}x{h4}", devices=n,
            psnr_vs_one_card_db=round(p, 2), bound_db=30.0,
            first_call_s=round(t_sh, 2))
    del projs, sharded, one

    w, h, f = proj.width, proj.height, float(proj.focal[0])
    poses = [orbit_pose(center, 1.0, theta=np.deg2rad(t))
             for t in np.linspace(-15.0, 15.0, 8 * n)]
    fmesh = make_mesh(("frame",), (n,), devices=devices)
    tmpl = Camera.create(w, h, focal_px=f)
    traj = render_fast_trajectory_sharded(
        proj, [p for p, _ in poses], tmpl, fmesh,
        cameras_rotations=[r for _, r in poses],
    )
    _check(len(traj.sharding.device_set) == n,
           f"trajectory shards on {len(traj.sharding.device_set)} devices")
    cams = [Camera.create(w, h, focal_px=f, position=p, rotation=r)
            for p, r in poses]
    ref = np.asarray(render_fast_batch(proj, cams))
    diff = float(np.abs(np.asarray(traj) - ref).max())
    _check(diff <= 1e-5, f"sharded trajectory max abs diff {diff}")
    fps, comp = _timed(lambda: _reduce(render_fast_trajectory_sharded(
        proj, [p for p, _ in poses], tmpl, fmesh,
        cameras_rotations=[r for _, r in poses])), len(poses))
    _report("four_trajectory", frames=len(poses), devices=n,
            max_abs_diff_vs_one_card=diff, fps=round(fps, 2),
            compile_s=round(comp, 2))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded phases")
    args = ap.parse_args(argv)

    # the host-CPU parity phase needs the CPU backend beside the GPU one
    plats = os.environ.get("JAX_PLATFORMS")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU (default device: {dev.platform})",
              file=sys.stderr)
        return 2
    n_need = 4 if args.four else 1
    gpus = jax.devices()[:n_need]
    _check(len(gpus) == n_need, f"need {n_need} GPUs, have {len(gpus)}")

    from lif_tpu import backend
    from lif_tpu.io.synthetic import (
        flagship_orbit_center,
        flagship_projector,
        flagship_scene,
    )

    backend.configure_compile_cache()
    card = _card()
    print(f"device_kind={dev.device_kind} count={len(jax.devices())}",
          flush=True)
    scene = flagship_scene(SEED)
    proj = flagship_projector(SEED).to_device()
    center = flagship_orbit_center(proj)
    if args.four:
        phase_four(proj, center, gpus)
    else:
        phase_exact(proj, scene, dev)
        phase_fast(proj, center, dev)
        phase_stereo_fused_mesh_billboard(proj, dev)
        phase_parity(proj, dev)
    for line in card[:n_need]:
        print(f"card: {line}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
