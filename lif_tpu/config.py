"""Central configuration: one frozen dataclass instead of scattered defaults.

The reference scatters its knobs across options objects, shader uniforms,
and magic numbers (SURVEY.md section 5 'Config / flag system'): baseline
0.063 m (HoloProjector.ts:106), 40 ray steps (rayCastMonoLDI.glsl:223),
max 4 layers (RaycastPlane.ts:218), feathering 0.1 (RaycastPlane.ts:107),
depthWrite/gradient-threshold (HoloRenderer.ts:77-135). Here they live in
one immutable RenderConfig with the same semantics and defaults, plus the
fast-path knobs (plane counts, chunking, precision).
"""

from __future__ import annotations

import dataclasses

__all__ = ["RenderConfig", "DEFAULT_CONFIG"]


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    # --- reference-equivalent knobs ---
    num_steps: int = 40  # ray-march steps (rayCastMonoLDI.glsl:223)
    max_layers: int = 4  # LDI layer cap (RaycastPlane.ts:218)
    default_baseline_m: float = 0.063  # HoloProjector.ts:106
    feathering: float = 0.1  # edge taper (RaycastPlane.ts:107)
    background: tuple = (0.0, 0.0, 0.0, 0.0)  # RaycastPlane.ts:108
    delta_invz_threshold: float = 0.0  # mesh gradient cull (HoloRenderer.ts:134)
    point_size: float = 1.0  # splat footprint scale (holoVertex.glsl:264)
    mask_dilation: float = 1.5  # stereo mask dilation (rayCastStereoLDI.glsl:135)
    # --- fast-path knobs ---
    sweep_planes: int = 40  # fast-renderer inverse-depth planes (sweep path)
    march_planes: int = 256  # march planes for plane_mode uniform/hybrid
    # sub-bracket refinement points per crossing. Default 0: measured on
    # the SFMoMA pose, sub-bracket first-crossing search catches grazing
    # crossings BETWEEN the march's own evaluation points, which lowers
    # PSNR vs the march family (39.6 -> 37.1 dB at K=256); plane density
    # is the honest fidelity lever (plane_mode / march_planes).
    march_refine: int = 0
    # snap-grid subsampling stride: planes at every `march_stride`-th
    # integer parallax (phase-aligned — warps stay exact translates).
    # >1 halves/quarters the march's plane-loop trip count; pair with
    # march_refine = stride - 1 to restore the skipped interior integer
    # planes exactly at flagged (crossing) planes only.
    march_stride: int = 1
    # march plane placement: 'snap' places planes at integer-pixel
    # parallax (exact warps — the sweep solves the continuous
    # first-crossing problem for bilinear sources exactly; 50.8 dB vs the
    # converged march on the SFMoMA pose vs ~40 dB for phase-misaligned
    # uniform grids of the same density); 'uniform' | 'hybrid' use
    # march_planes fixed-size grids (ops/sweep_march.snap_plane_table).
    plane_mode: str = "snap"
    # two-phase rotated march (ops/rotated_march): in-bracket sub-sweep
    # count and plane step. Unlike the lateral snap grid (where refine
    # HURT, see march_refine), scaled grids have per-pixel sampling
    # phases, so density + refine is the fidelity lever there.
    rotated_refine: int = 2
    rotated_step_px: float = 1.0  # max displacement change per plane, px
    # single-phase target-ray march (ops/sweep_target): the production
    # rotated tier. Plane density = max L1 source-path length per plane
    # over the image corners. No refine knob: the tier marches
    # depth-only and fetches color with one exact bilinear gather at
    # the solved position (render_target_fetch_batch) — in-bracket
    # refine was measured to not help (39.34 -> 39.45 dB) while the
    # fetch gains +7..13 dB over the bracket color lerp.
    target_step_px: float = 1.0
    # in-bracket DEPTH sub-sweep on the target tier's depth-only march
    # (pass2d): with target_step_px widened to s, target_refine = s - 1
    # restores the dense ladder's solved-invz accuracy at flagged planes
    # only — pass 1's plane-loop trip count drops ~s x (the orbit tier's
    # throughput lever; the color fetch is already exact either way).
    target_refine: int = 0
    # multi-projector fusion: candidates whose frontmost absolute
    # inverse depth is within this RELATIVE tolerance of the nearest
    # are blended with triangular weights (w = 1 at the front, 0 at the
    # tolerance edge) instead of a hard nearest-wins argmax. A hard
    # merge is discontinuous in depth, so near-equal surfaces (e.g. the
    # same scene seen by several projectors) flip winners on snap-plane
    # discretization noise — measured ~11 dB of fusion PSNR on the
    # 4-projector SFMoMA config. 0 recovers the hard merge (exact ties
    # still average). The scale: one snap-plane step at mid-scene depth
    # is ~2% of invz (1/(f*cx) at f~1000, cx~0.05), so 0.05 spans a
    # couple of planes.
    fuse_tol: float = 0.05
    # pose-batch chunk INSIDE one device dispatch: batches larger than
    # this run as a lax.map over fixed-size chunks (one compiled body,
    # bounded intermediates) instead of growing the kernel batch axis.
    # One dispatch serves arbitrarily many poses, while per-chunk device
    # intermediates stay ~chunk x 30 MB.
    pose_chunk: int = 48
    sweep_softness: float = 0.5  # occupancy width / local plane spacing
    sweep_chunk: int = 2  # planes per batched-matmul chunk
    color_dtype: str = "bfloat16"  # fast-path color warp precision
    to_srgb: bool = True

    def replace(self, **kwargs) -> "RenderConfig":
        return dataclasses.replace(self, **kwargs)


DEFAULT_CONFIG = RenderConfig()
