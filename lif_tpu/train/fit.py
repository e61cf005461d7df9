"""Differentiable-rendering optimization: refine depth and pose by gradient.

A capability the WebGL reference cannot express: because the whole render
is a pure jitted function, we can optimize scene parameters (the inverse-
depth map, the projector pose) against target photographs by gradient
descent — scene fitting / pose registration. This module is also the
framework's canonical multi-chip TRAINING STEP: the batch of target frames
shards over a 'data' mesh axis and image rows over a 'tile' axis via
sharding annotations (GSPMD inserts the collectives).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from ..ops import sweep as _sweep
from .losses import l2_loss

# 3x3 products in full f32 (a GPU runs a bare f32 matmul in TF32)
_HIGHEST = jax.lax.Precision.HIGHEST

__all__ = ["FitParams", "TrainState", "make_train_step", "fit_projector"]


class FitParams(NamedTuple):
    """Learnable scene parameters."""

    disp: jnp.ndarray  # (L, H, W) inverse-depth maps (the main unknowns)
    position_delta: jnp.ndarray  # (3,) pose correction
    rotation_delta: jnp.ndarray  # (3,) axis-angle pose correction


class TrainState(NamedTuple):
    params: FitParams
    opt_state: optax.OptState
    step: jnp.ndarray


def _rodrigues(w):
    """exp of an axis-angle vector -> rotation matrix (differentiable)."""
    theta = jnp.sqrt(jnp.sum(w * w) + 1e-12)
    k = w / theta
    kx = jnp.array(
        [
            [0.0, -k[2], k[1]],
            [k[2], 0.0, -k[0]],
            [-k[1], k[0], 0.0],
        ]
    )
    s = jnp.sin(theta)
    c = jnp.cos(theta)
    kx2 = jnp.matmul(kx, kx, precision=_HIGHEST)
    return jnp.eye(3) + s * kx + (1.0 - c) * kx2


def render_with_params(
    params: FitParams,
    static_proj: dict,
    rel_positions,
    rel_rotations,
    out_w: int,
    out_h: int,
    num_layers: int,
    num_steps: int = 12,
):
    """Render a BATCH of frames from the learnable parameters.

    rel_positions (B, 3) / rel_rotations (B, 3, 3) are base camera-local
    projector poses (shader convention); the learned pose delta is applied
    on top. Batch is handled by broadcasting (never vmap — see
    ops/raycast.py). Output is linear-light (B, out_h, out_w, 3)."""
    d_rot = _rodrigues(params.rotation_delta)
    rot = jnp.einsum(
        "ij,bjk->bik", d_rot, rel_rotations, precision=_HIGHEST
    )
    pos = rel_positions + params.position_delta[None, :]

    # The SOFT plane sweep, not the hard march: the march's surface
    # crossings are discrete decisions with exactly zero gradient w.r.t.
    # the depth map; the sweep's sigmoid occupancy is differentiable.
    img = _sweep.render_sweep(
        static_proj["rgb"],
        jnp.clip(params.disp, 0.0, 1.0),
        static_proj["mask"],
        static_proj["layer_res"],
        static_proj["invz_min"],
        static_proj["invz_max"],
        static_proj["focal"],
        static_proj["skew"],
        pos,
        rot,
        static_proj["f2"],
        static_proj["skew2"],
        jnp.zeros(4, jnp.float32),
        out_w=out_w,
        out_h=out_h,
        num_layers=num_layers,
        num_planes=num_steps,
        to_srgb=False,
    )
    return img[..., :3]


def make_train_step(
    static_proj: dict,
    out_w: int,
    out_h: int,
    num_layers: int,
    optimizer: optax.GradientTransformation,
    num_steps: int = 12,
):
    """Build the jitted train step: (state, rel_poses, targets) -> state, loss."""

    def loss_fn(params, rel_positions, rel_rotations, targets):
        pred = render_with_params(
            params, static_proj, rel_positions, rel_rotations,
            out_w, out_h, num_layers, num_steps,
        )
        return l2_loss(pred, targets)

    @jax.jit
    def train_step(state: TrainState, rel_positions, rel_rotations, targets):
        loss, grads = jax.value_and_grad(loss_fn)(
            state.params, rel_positions, rel_rotations, targets
        )
        updates, opt_state = optimizer.update(grads, state.opt_state, state.params)
        params = optax.apply_updates(state.params, updates)
        return TrainState(params, opt_state, state.step + 1), loss

    return train_step


def fit_projector(
    projector,
    cameras_positions,
    cameras_rotations,
    camera_template,
    targets,
    steps: int = 50,
    learning_rate: float = 2e-3,
    num_steps: int = 12,
    mesh=None,
    data_axis: str = "data",
    tile_axis: str | None = "tile",
):
    """Fit a projector's depth map (+pose delta) to target images.

    targets: (B, H, W, 3) linear-light, GL-oriented. With `mesh` given, the
    batch is sharded over `data_axis` and image rows over `tile_axis`
    (GSPMD); without it, single-device.

    Returns (fitted FitParams, list of losses).
    """
    from ..core.pose import relative_view_pose
    from jax.sharding import NamedSharding, PartitionSpec as P

    b = len(cameras_positions)
    rel_p = np.zeros((b, 3), np.float32)
    rel_r = np.zeros((b, 3, 3), np.float32)
    for i in range(b):
        p_i, r_i = relative_view_pose(
            np.asarray(projector.position, np.float64),
            np.asarray(projector.rotation, np.float64),
            np.asarray(cameras_positions[i], np.float64),
            np.asarray(cameras_rotations[i], np.float64),
        )
        rel_p[i] = p_i
        rel_r[i] = r_i

    baseline = jnp.asarray(projector.baseline, jnp.float32)
    static_proj = dict(
        rgb=jnp.asarray(projector.rgb),
        mask=jnp.asarray(projector.mask),
        layer_res=jnp.asarray(projector.layer_res),
        invz_min=jnp.asarray(projector.invz_min, jnp.float32) / baseline,
        invz_max=jnp.asarray(projector.invz_max, jnp.float32) / baseline,
        focal=jnp.asarray(projector.focal),
        skew=jnp.asarray(projector.skew),
        f2=jnp.asarray(camera_template.focal_px, jnp.float32),
        skew2=jnp.asarray(camera_template.skew, jnp.float32),
    )

    params = FitParams(
        disp=jnp.asarray(projector.disp),
        position_delta=jnp.zeros(3, jnp.float32),
        rotation_delta=jnp.zeros(3, jnp.float32),
    )
    optimizer = optax.adam(learning_rate)
    state = TrainState(params, optimizer.init(params), jnp.int32(0))

    rel_p = jnp.asarray(rel_p)
    rel_r = jnp.asarray(rel_r)
    targets = jnp.asarray(targets, jnp.float32)

    if mesh is not None:
        specs = [P(data_axis), P(data_axis), P(data_axis)]
        if tile_axis is not None and tile_axis in mesh.shape:
            specs[2] = P(data_axis, tile_axis)  # targets (B, H, W, 3)
        rel_p = jax.device_put(rel_p, NamedSharding(mesh, specs[0]))
        rel_r = jax.device_put(rel_r, NamedSharding(mesh, specs[1]))
        targets = jax.device_put(targets, NamedSharding(mesh, specs[2]))

    train_step = make_train_step(
        static_proj,
        camera_template.width,
        camera_template.height,
        projector.num_layers,
        optimizer,
        num_steps=num_steps,
    )

    losses = []
    for _ in range(steps):
        state, loss = train_step(state, rel_p, rel_r, targets)
        losses.append(float(loss))
    return state.params, losses
