"""Multi-device rendering: image-tile, frame, and projector parallelism.

The reference is single-browser/single-GPU (SURVEY.md section 2.5); this is
the scaling design it lacks:

  * TILE parallelism (the TP/SP analog): the output framebuffer is sharded
    over a mesh axis; every device renders its row-band of the same virtual
    image (pure map — each ray march reads only the replicated source
    textures, so no collectives are needed until assembly).
  * FRAME parallelism (the DP analog): a trajectory's cameras are sharded
    over a mesh axis; each device renders different frames.
  * PROJECTOR (view) parallelism (the EP analog): each device renders a
    different projector; the fused image is a nearest-depth merge across
    the view axis using `pmax`/`psum` collectives.

All entry points take an explicit `jax.sharding.Mesh`; tests exercise them
on a virtual 8-device CPU mesh.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from jax import shard_map

from ..core.pose import relative_view_pose
from ..ops import raycast as _raycast

__all__ = [
    "make_mesh",
    "render_view_tiled",
    "render_trajectory_sharded",
    "render_fast_trajectory_sharded",
    "render_fused_projectors",
]


def make_mesh(axis_names=("tile",), shape=None, devices=None) -> Mesh:
    """A Mesh over the available devices (1-D by default)."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    if shape is None:
        shape = (len(devices),) if len(axis_names) == 1 else None
    if shape is None:
        raise ValueError("shape required for multi-axis meshes")
    return Mesh(devices.reshape(shape), axis_names)


def _projector_kernel_args(projector, camera):
    """(array args..., static kwargs) for ops.raycast.render_mono."""
    pos, rot = relative_view_pose(
        np.asarray(projector.position, np.float64),
        np.asarray(projector.rotation, np.float64),
        np.asarray(camera.position, np.float64),
        np.asarray(camera.rotation, np.float64),
    )
    baseline = jnp.asarray(projector.baseline, jnp.float32)
    arrays = (
        jnp.asarray(projector.rgb),
        jnp.asarray(projector.disp),
        jnp.asarray(projector.mask),
        jnp.asarray(projector.layer_res),
        jnp.asarray(projector.invz_min, jnp.float32) / baseline,
        jnp.asarray(projector.invz_max, jnp.float32) / baseline,
        jnp.asarray(projector.focal),
        jnp.asarray(projector.skew),
        jnp.asarray(pos, jnp.float32),
        jnp.asarray(rot, jnp.float32),
        jnp.asarray(camera.focal_px, jnp.float32),
        jnp.asarray(camera.skew, jnp.float32),
    )
    return arrays


def render_view_tiled(
    projector,
    camera,
    mesh: Mesh,
    axis_name: str = "tile",
    background=(0.0, 0.0, 0.0, 0.0),
    mask_mode: str | None = None,
    **kwargs,
):
    """Render one view with the output image row-sharded over `axis_name`.

    Source textures are replicated; device i renders rows
    [i*H/n, (i+1)*H/n). Returns the assembled (H, W, 4) image (sharded
    array; XLA inserts the gather on host fetch)."""
    n = mesh.shape[axis_name]
    if camera.height % n:
        raise ValueError(f"height {camera.height} not divisible by {n} tiles")
    tile_h = camera.height // n
    if mask_mode is None:
        mask_mode = "multiply" if projector.num_layers > 1 else "none"

    arrays = _projector_kernel_args(projector, camera)
    bg = jnp.asarray(background, jnp.float32)

    def tile_fn(*args):
        i = jax.lax.axis_index(axis_name)
        return _raycast.render_mono(
            *args[:-1],
            args[-1],
            out_w=camera.width,
            out_h=tile_h,
            num_layers=projector.num_layers,
            full_h=camera.height,
            row_start=i * tile_h,
            mask_mode=mask_mode,
            **kwargs,
        )

    fn = shard_map(
        tile_fn,
        mesh=mesh,
        in_specs=tuple(P() for _ in range(len(arrays) + 1)),
        out_specs=P(axis_name, None, None),
        check_vma=False,
    )
    return fn(*arrays, bg)


def render_trajectory_sharded(
    projector,
    cameras_positions,
    cameras_rotations,
    camera_template,
    mesh: Mesh,
    axis_name: str = "frame",
    background=(0.0, 0.0, 0.0, 0.0),
    mask_mode: str | None = None,
    **kwargs,
):
    """Render a batch of frames, sharded over `axis_name` (data parallel).

    `cameras_positions` (F, 3) / `cameras_rotations` (F, 3, 3) are world
    camera poses; F must be divisible by the axis size. Frames are rendered
    with the batch-polymorphic kernel (leading batch dim broadcast, not
    vmap). Returns (F, H, W, 4) sharded on frames."""
    n = mesh.shape[axis_name]
    f = len(cameras_positions)
    if f % n:
        raise ValueError(f"{f} frames not divisible by {n} devices")
    if mask_mode is None:
        mask_mode = "multiply" if projector.num_layers > 1 else "none"

    # camera-local projector pose per frame (host-side, tiny)
    pos = np.zeros((f, 3), np.float32)
    rot = np.zeros((f, 3, 3), np.float32)
    for i in range(f):
        p_i, r_i = relative_view_pose(
            np.asarray(projector.position, np.float64),
            np.asarray(projector.rotation, np.float64),
            np.asarray(cameras_positions[i], np.float64),
            np.asarray(cameras_rotations[i], np.float64),
        )
        pos[i] = p_i
        rot[i] = r_i

    baseline = jnp.asarray(projector.baseline, jnp.float32)
    shared = (
        jnp.asarray(projector.rgb),
        jnp.asarray(projector.disp),
        jnp.asarray(projector.mask),
        jnp.asarray(projector.layer_res),
        jnp.asarray(projector.invz_min, jnp.float32) / baseline,
        jnp.asarray(projector.invz_max, jnp.float32) / baseline,
        jnp.asarray(projector.focal),
        jnp.asarray(projector.skew),
    )
    cam = camera_template

    def frames_fn(pos_shard, rot_shard, *args):
        return _raycast.render_mono(
            *args[:8],
            pos_shard,  # (F/n, 3) -> batch dims broadcast in the kernel
            rot_shard,
            jnp.asarray(cam.focal_px, jnp.float32),
            jnp.asarray(cam.skew, jnp.float32),
            jnp.asarray(background, jnp.float32),
            out_w=cam.width,
            out_h=cam.height,
            num_layers=projector.num_layers,
            mask_mode=mask_mode,
            **kwargs,
        )

    fn = shard_map(
        frames_fn,
        mesh=mesh,
        in_specs=(P(axis_name), P(axis_name)) + tuple(P() for _ in shared),
        out_specs=P(axis_name, None, None, None),
        check_vma=False,
    )
    return fn(jnp.asarray(pos), jnp.asarray(rot), *shared)


def _fuse_across_views(rgba, front_inv_depth, background, axis_name,
                       to_srgb: bool = True, fuse_tol: float | None = None):
    """Tolerance-blended nearest-surface merge across the sharded view axis.

    rgba: this view's composited (premultiplied) LDI render; front_inv_depth
    its frontmost hit in ABSOLUTE 1/m units (comparable across projectors
    with different baselines), 0 where nothing was hit. The frontmost
    surface is found with `pmax`; candidates within the relative depth
    tolerance blend with triangular weights via `psum`s (the same
    _fusion_weights spec as the single-chip render_fused_fast — a hard
    argmax flips winners on depth-discretization noise when several
    projectors see the same surface). Deterministic under any device
    order; fuse_tol=0 recovers hard nearest-wins with tie averaging."""
    from ..config import DEFAULT_CONFIG
    from ..models.renderer import _fusion_weights

    tol = DEFAULT_CONFIG.fuse_tol if fuse_tol is None else fuse_tol
    hit = rgba[..., 3] > 0.0
    key = jnp.where(hit, front_inv_depth, -jnp.inf)
    best = jax.lax.pmax(key, axis_name)
    w = _fusion_weights(key, best, hit, tol)
    wsum = jnp.maximum(jax.lax.psum(w, axis_name), 1e-12)
    color = jax.lax.psum(w[..., None] * rgba[..., :3], axis_name) / wsum[..., None]
    alpha = jax.lax.psum(w * rgba[..., 3], axis_name) / wsum
    alpha = jnp.where(jnp.isfinite(best), alpha, 0.0)
    from ..ops.composite import finish_over_background

    return finish_over_background(color, alpha, background, to_srgb=to_srgb)


def render_fused_projectors(
    projectors,
    camera,
    mesh: Mesh,
    axis_name: str = "view",
    tile_axis: str | None = None,
    background=(0.0, 0.0, 0.0, 0.0),
    mask_mode: str | None = None,
    to_srgb: bool = True,
    fuse_tol: float | None = None,
    **kwargs,
):
    """Fuse multiple projectors into one view, projector-sharded.

    Each device raycasts ITS projector — the FULL LDI stack, composited
    front-to-back with the reference's mask semantics — then the fused
    image is assembled with collectives: the frontmost absolute
    inverse depth via `pmax`, then a tolerance-blended merge with
    weighted `psum`s (_fuse_across_views). This is the multi-projector fusion the reference
    lacks (it renders only the first projector; HoloRenderer.ts:186-189).

    tile_axis: optional SECOND mesh axis composing view parallelism with
    tile parallelism — on a (view, tile) 2-D mesh each device raycasts
    its projector's row-band of the framebuffer, and the fusion
    collectives reduce over the view axis only (per tile). This is the
    composed 4-projector-4K shape of BASELINE configs[4]: views AND the
    output image sharded across chips at once.

    mask_mode: None -> per-projector reference default (multiply for LDI,
    none for single-layer), or explicit 'multiply'/'none'.
    """
    n = mesh.shape[axis_name]
    if len(projectors) != n:
        raise ValueError(f"need exactly {n} projectors for a {n}-way mesh")
    if tile_axis is not None:
        n_tiles = mesh.shape[tile_axis]
        if camera.height % n_tiles:
            raise ValueError(
                f"height {camera.height} not divisible by {n_tiles} tiles"
            )
        tile_h = camera.height // n_tiles
    else:
        tile_h = camera.height

    p0 = projectors[0]
    num_layers = max(p.num_layers for p in projectors)
    poss, rots = [], []
    for p in projectors:
        if (p.height, p.width) != (p0.height, p0.width):
            raise ValueError("fused projectors must share dimensions")
        pos, rot = relative_view_pose(
            np.asarray(p.position, np.float64),
            np.asarray(p.rotation, np.float64),
            np.asarray(camera.position, np.float64),
            np.asarray(camera.rotation, np.float64),
        )
        poss.append(pos)
        rots.append(rot)

    stack = lambda xs, dt=jnp.float32: jnp.asarray(np.stack(xs), dt)
    bg = jnp.asarray(background, jnp.float32)
    modes = tuple(
        (mask_mode or ("multiply" if p.num_layers > 1 else "none"))
        for p in projectors
    )
    if len(set(modes)) != 1:
        # shard_map traces ONE program for all shards; mixed per-view mask
        # modes would need branching on the axis index. Use the common
        # reference behaviour of the group.
        modes = ("multiply",) * n
    mode = modes[0]
    layer_counts = tuple(p.num_layers for p in projectors)

    def view_fn(rgb, disp, m_arr, layer_res, izmin, izmax, focal, skew,
                pos, rot, nlay):
        # shard_map gives each device a leading dim of 1; drop it
        rgb, disp, m_arr = rgb[0], disp[0], m_arr[0]
        layer_res, izmin, izmax = layer_res[0], izmin[0], izmax[0]
        focal, skew, pos, rot = focal[0], skew[0], pos[0], rot[0]
        nlay = nlay[0]

        row_start = (
            jax.lax.axis_index(tile_axis) * tile_h
            if tile_axis is not None
            else 0
        )
        s2x, s2y = _raycast._pixel_grid(
            camera.width, tile_h, full_h=camera.height,
            row_start=row_start,
        )
        from ..core.transforms import mat_from_focal, mm

        fskr2 = _raycast.build_fskr2(
            jnp.asarray(camera.focal_px, jnp.float32),
            float(camera.width),
            float(camera.height),
            jnp.asarray(camera.skew, jnp.float32),
        )
        skr1 = _raycast.build_skr1(skew, rot)

        acc_rgb = jnp.zeros((tile_h, camera.width, 3), jnp.float32)
        acc_a = jnp.zeros((tile_h, camera.width), jnp.float32)
        front = jnp.zeros((tile_h, camera.width), jnp.float32)
        for i in range(num_layers):
            w_i = layer_res[i, 0]
            h_i = layer_res[i, 1]
            fskr1 = mm(
                mat_from_focal(focal[i] / w_i, focal[i] / h_i), skr1
            )
            rgba, invz2, _ = _raycast.raycast_layer(
                s2x, s2y, fskr1, pos, fskr2, jnp.zeros(3, jnp.float32),
                rgb[i], disp[i], m_arr[i], izmin[i], izmax[i],
                w_i, h_i, bg[:3], 0.1, mask_mode=mode, **kwargs,
            )
            live = (jnp.float32(i) < nlay).astype(jnp.float32)
            a = rgba[..., 3] * live
            acc_rgb = acc_rgb + (1.0 - acc_a[..., None]) * a[..., None] * rgba[..., :3]
            # frontmost hit inverse depth. invz2 is ALREADY absolute 1/m:
            # the layer izmin/izmax fed to the kernel were divided by
            # baseline above, and depth = baseline/invz_LIF — so it
            # compares across projectors with different baselines as-is
            # (dividing by baseline again was a measured bug that made
            # the farther surface win; tests/test_fusion.py)
            new_hit = (a > 0.0) & (front == 0.0)
            front = jnp.where(new_hit, invz2, front)
            acc_a = acc_a + (1.0 - acc_a) * a
        view_rgba = jnp.concatenate([acc_rgb, acc_a[..., None]], axis=-1)
        return _fuse_across_views(
            view_rgba, front, bg, axis_name, to_srgb=to_srgb,
            fuse_tol=fuse_tol,
        )[None]

    fn = shard_map(
        view_fn,
        mesh=mesh,
        in_specs=tuple(P(axis_name) for _ in range(11)),
        out_specs=P(axis_name, tile_axis, None, None),
        check_vma=False,
    )
    def padL(a, pad_edge=True):
        """Pad a per-layer leading axis to the shared num_layers (edge
        padding keeps intrinsics/dims valid; padded layers are dead via
        the `live` gate)."""
        a = np.asarray(a)
        if a.shape[0] == num_layers:
            return a
        reps = [(0, num_layers - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
        return np.pad(a, reps, mode="edge" if pad_edge else "constant")

    out = fn(
        stack([padL(p.rgb) for p in projectors]),
        stack([padL(p.disp) for p in projectors]),
        stack([padL(p.mask) for p in projectors]),
        stack([padL(p.layer_res) for p in projectors]),
        stack([padL(np.asarray(p.invz_min) / float(p.baseline)) for p in projectors]),
        stack([padL(np.asarray(p.invz_max) / float(p.baseline)) for p in projectors]),
        stack([padL(p.focal) for p in projectors]),
        stack([np.asarray(p.skew) for p in projectors]),
        stack(poss),
        stack(rots),
        stack([float(c) for c in layer_counts]),
    )
    return out[0]  # all shards carry the same fused image


def render_fast_trajectory_sharded(
    projector,
    cameras_positions,
    camera_template,
    mesh: Mesh,
    axis_name: str = "frame",
    cameras_rotations=None,
    background=(0.0, 0.0, 0.0, 0.0),
    num_planes: int | None = None,
    feathering: float = 0.1,
    mask_mode: str | None = None,
    to_srgb: bool = True,
    **kwargs,
):
    """Data-parallel trajectory rendering on the PRODUCTION fast kernel:
    frames shard over `axis_name`, each device runs the batched march
    tiers (the GPU kernel where backend.march_impl picks it, the XLA
    implementations elsewhere) on its frame shard
    against replicated source textures. The multi-chip counterpart of
    models.renderer.render_fast_batch; the raycast-kernel variant is
    render_trajectory_sharded.

    ANY pose family the fast batch covers shards: lateral translation
    (snap march), aligned xyz/zoom (scaled), yaw/pitch orbits (target
    tier — the flagship trajectory workload), general rotations
    (rotated tier), and skewed frustums. The tier plans are pose-batch
    unions, so every device compiles the SAME program; only the
    per-pose arrays (c1/rot, snap tables, target pose tables) shard.

    `cameras_positions` (F, 3) world camera positions and optional
    `cameras_rotations` (F, 3, 3) world camera rotations; F must divide
    by the axis size. Returns (F, H, W, 4) sharded on frames.
    """
    from ..core.camera import Camera
    from ..models.renderer import render_fast_batch

    cam = camera_template
    f = len(cameras_positions)
    rots = (
        [np.asarray(cam.rotation, np.float64)] * f
        if cameras_rotations is None
        else [np.asarray(r, np.float64) for r in cameras_rotations]
    )
    cams = [
        Camera.create(
            cam.width, cam.height, focal_px=float(cam.focal_px),
            position=np.asarray(p, np.float64), rotation=r,
            skew=np.asarray(cam.skew),
        )
        for p, r in zip(cameras_positions, rots)
    ]
    return render_fast_batch(
        projector, cams, background=background, num_planes=num_planes,
        feathering=feathering, mask_mode=mask_mode, to_srgb=to_srgb,
        shard_mesh=mesh, shard_axis=axis_name, **kwargs,
    )
