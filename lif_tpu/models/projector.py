"""Projector: the scene object holding textures, intrinsics, and pose.

A JAX redesign of the reference's HoloProjector
(reference: src/HoloProjector.ts:35-376): instead of a THREE.Object3D with
async-loading textures, a Projector is a frozen pytree of stacked, padded
layer arrays — directly consumable by the jitted render kernels and
shardable across devices. `HoloProjectorOptions` semantics are preserved:
intrinsics {fx, fy, cx, cy} in pixels, invDepthRange {min, max, baseline},
width/height (BASELINE.json north star).
"""

from __future__ import annotations

import numpy as np
from ..core.pytree import pytree_dataclass, static_field

from ..core import pose as _pose
from ..io import decode as _decode

__all__ = [
    "Projector",
    "projector_from_arrays",
    "projector_from_lif_view",
    "resample_projector",
]

MAX_LAYERS = 4  # reference: RaycastPlane.ts:218


@pytree_dataclass
class Projector:
    """A light-field projector: LDI layer stack + pinhole model + world pose.

    Array fields (pytree leaves):
      rgb: (L, Hmax, Wmax, 3) float32 linear-light colours, GL-oriented,
        padded to the largest layer.
      disp: (L, Hmax, Wmax) float32 normalized inverse depth in [0, 1].
      mask: (L, Hmax, Wmax) float32 alpha mask (ones when absent).
      layer_res: (L, 2) float32 logical (width, height) per layer
        (outpainted LDI layers can be larger than the base view,
        reference LifLoader.ts:521-526).
      invz_min/invz_max: (L,) inverse-depth range per layer (LIF units, 1/m;
        the kernels divide by `baseline` — reference RaycastPlane.ts:476-478).
      focal: (L,) focal length in source pixels per layer.
      skew: (2,) source frustum-skew tangents (sk1).
      position: (3,) world position. rotation: (3, 3) world rotation.
      baseline: () baseline in meters (reference HoloProjector.ts:106
        default 0.063).

    Static fields: num_layers, width, height (of the base view).
    """

    rgb: np.ndarray
    disp: np.ndarray
    mask: np.ndarray
    layer_res: np.ndarray
    invz_min: np.ndarray
    invz_max: np.ndarray
    focal: np.ndarray
    skew: np.ndarray
    position: np.ndarray
    rotation: np.ndarray
    baseline: np.ndarray
    num_layers: int = static_field()
    width: int = static_field()
    height: int = static_field()

    def to_device(self) -> "Projector":
        """Device-resident copy: uploads every array field once. Call this
        before steady-state rendering — otherwise each render call re-sends
        ~20 MB of textures host->device."""
        import jax

        return jax.device_put(self)

    @property
    def intrinsics(self) -> dict:
        """Pixel intrinsics of the base view (fx = fy; centered principal
        point unless skewed — reference LifLoader.ts:112-130)."""
        fx = float(self.focal[0])
        cx = self.width / 2.0 - float(self.skew[0]) * fx
        cy = self.height / 2.0 - float(self.skew[1]) * fx
        return {"fx": fx, "fy": fx, "cx": cx, "cy": cy}

    @property
    def inv_depth_range(self) -> dict:
        return {
            "min": float(self.invz_min[0]),
            "max": float(self.invz_max[0]),
            "baseline": float(self.baseline),
        }

    def frustum_corners(self) -> np.ndarray:
        """8 frustum corners in projector-local space.
        reference: HoloProjector.ts:388-433."""
        from ..core.camera import frustum_corners

        return frustum_corners(
            self.intrinsics,
            self.width,
            self.height,
            float(self.invz_min[0]),
            float(self.invz_max[0]),
            float(self.baseline),
        )


def projector_from_arrays(
    rgb,
    disp,
    mask=None,
    *,
    focal_px: float,
    invz_min: float,
    invz_max: float,
    baseline: float = 0.063,
    skew=(0.0, 0.0),
    position=(0.0, 0.0, 0.0),
    rotation=None,
    extra_layers: list[dict] | None = None,
) -> Projector:
    """Build a Projector from in-memory arrays (single or multi layer).

    ``rgb`` (H, W, 3) linear GL-oriented, ``disp`` (H, W) in [0,1].
    ``extra_layers``: optional list of dicts with keys rgb/disp/mask/
    focal_px/invz_min/invz_max for LDI layers beyond the first.
    This is the `HoloProjectorOptions` analog (HoloProjector.ts:6-33).
    """
    layers = [
        dict(
            rgb=np.asarray(rgb, np.float32),
            disp=np.asarray(disp, np.float32),
            mask=None if mask is None else np.asarray(mask, np.float32),
            focal_px=focal_px,
            invz_min=invz_min,
            invz_max=invz_max,
        )
    ]
    layers.extend(extra_layers or [])
    return _stack_layers(
        layers,
        skew=skew,
        position=position,
        rotation=rotation,
        baseline=baseline,
    )


def _stack_layers(layers, *, skew, position, rotation, baseline) -> Projector:
    n = min(len(layers), MAX_LAYERS)
    layers = layers[:n]
    h_max = max(l["rgb"].shape[0] for l in layers)
    w_max = max(l["rgb"].shape[1] for l in layers)

    rgb = np.zeros((n, h_max, w_max, 3), np.float32)
    disp = np.zeros((n, h_max, w_max), np.float32)
    mask = np.zeros((n, h_max, w_max), np.float32)
    layer_res = np.zeros((n, 2), np.float32)
    invz_min = np.zeros((n,), np.float32)
    invz_max = np.zeros((n,), np.float32)
    focal = np.zeros((n,), np.float32)

    for i, l in enumerate(layers):
        h, w = l["rgb"].shape[:2]
        rgb[i, :h, :w] = l["rgb"]
        disp[i, :h, :w] = l["disp"]
        mask[i, :h, :w] = (
            np.ones((h, w), np.float32) if l.get("mask") is None else l["mask"]
        )
        layer_res[i] = (w, h)
        invz_min[i] = l["invz_min"]
        invz_max[i] = l["invz_max"]
        focal[i] = l["focal_px"]

    base_h, base_w = layers[0]["rgb"].shape[:2]
    return Projector(
        rgb=rgb,
        disp=disp,
        mask=mask,
        layer_res=layer_res,
        invz_min=invz_min,
        invz_max=invz_max,
        focal=focal,
        skew=np.asarray(skew, np.float32),
        position=np.asarray(position, np.float32),
        rotation=np.asarray(
            np.eye(3) if rotation is None else rotation, np.float32
        ),
        baseline=np.float32(baseline),
        num_layers=n,
        width=int(base_w),
        height=int(base_h),
    )


def projector_from_lif_view(view: dict, baseline_meters: float = 0.063) -> Projector:
    """Build a Projector from a normalized LIF view dict.

    Faithful to createHoloProjectorFromLifView (reference:
    src/LifLoader.ts:100-208):
      * frustum_skew (array or {x,y} form) carried as sk1; the derived
        principal point is cx = W/2 - skew.x*focal (exposed via
        Projector.intrinsics);
      * LIF positions are baseline-normalized -> scaled to meters;
      * rotation converted via the LIF slant/roll encoding;
      * LDI layers from layers_top_to_bottom with the per-layer
        intrinsics fallback chain (HoloProjector.ts:294-376).
    """
    skew_raw = view.get("frustum_skew")
    if skew_raw is None:
        skew = (0.0, 0.0)
    elif isinstance(skew_raw, dict):
        skew = (float(skew_raw.get("x", 0.0)), float(skew_raw.get("y", 0.0)))
    else:
        skew = (float(skew_raw[0]), float(skew_raw[1]))

    position = np.asarray(
        [float(v) for v in (view.get("position") or (0.0, 0.0, 0.0))]
    ) * baseline_meters  # LIF positions are baseline-normalized (:169-189)
    rotation = (
        _pose.lif_rotation_to_matrix(view["rotation"])
        if view.get("rotation") is not None
        else np.eye(3)
    )

    def layer_from(obj, fallback):
        w = int(obj.get("width_px") or fallback["width_px"])
        h = int(obj.get("height_px") or fallback["height_px"])
        focal = float(obj.get("focal_px") or fallback["focal_px"])
        cam = obj.get("camera_data")
        if cam:  # per-layer intrinsics fallback (HoloProjector.ts:332-348)
            focal = cam["focal_ratio_to_width"] * w
        invz = obj.get("inv_z_map") or fallback["inv_z_map"]
        rgb = _decode.decode_rgb(obj["image"]["bytes"])
        disp_src = obj.get("inv_z_map", {}).get("bytes") or fallback["inv_z_map"]["bytes"]
        disp = _decode.decode_depth(disp_src)
        mask_bytes = (obj.get("mask") or {}).get("bytes")
        mask = (
            None
            if mask_bytes is None
            else _decode.decode_mask(mask_bytes, disp.shape)
        )
        return dict(
            rgb=rgb,
            disp=disp,
            mask=mask,
            focal_px=focal,
            invz_min=float(invz["min"]),
            invz_max=float(invz["max"]),
        )

    ldi = view.get("layers_top_to_bottom")
    if ldi:
        layers = [layer_from(layer, view) for layer in ldi]
    else:
        layers = [layer_from(view, view)]

    return _stack_layers(
        layers,
        skew=skew,
        position=position,
        rotation=rotation,
        baseline=baseline_meters,
    )


def resample_projector(
    projector: Projector,
    scale: float,
    out_w: int | None = None,
    out_h: int | None = None,
) -> Projector:
    """Bilinearly resample every layer by `scale` (focal scales with it),
    optionally center-cropping to (out_w, out_h).

    The offline analog of the reference's viewport scaling
    (textureUtils.ts:126-136 calculateViewportScale): rendering at an
    output resolution other than the source's. A center crop keeps the
    principal point centered, so the resampled projector stays valid for
    the centered-pp fast paths; inverse-depth ranges and pose are
    resolution-independent and unchanged. Used by the 4K fused-projector
    benchmark (BASELINE configs[4]) to feed the lateral march, whose
    output dims must equal the source dims.
    """
    import jax
    import jax.numpy as jnp

    n = projector.num_layers
    layers = []
    for i in range(n):
        w_i = int(projector.layer_res[i, 0])
        h_i = int(projector.layer_res[i, 1])
        nw, nh = round(w_i * scale), round(h_i * scale)
        rgb = jax.image.resize(
            jnp.asarray(projector.rgb[i, :h_i, :w_i]), (nh, nw, 3), "bilinear"
        )
        disp = jax.image.resize(
            jnp.asarray(projector.disp[i, :h_i, :w_i]), (nh, nw), "bilinear"
        )
        m = jax.image.resize(
            jnp.asarray(projector.mask[i, :h_i, :w_i]), (nh, nw), "bilinear"
        )
        cw = min(out_w or nw, nw)
        ch = min(out_h or nh, nh)
        x0, y0 = (nw - cw) // 2, (nh - ch) // 2
        layers.append(dict(
            rgb=np.asarray(rgb[y0 : y0 + ch, x0 : x0 + cw]),
            disp=np.asarray(disp[y0 : y0 + ch, x0 : x0 + cw]),
            mask=np.asarray(m[y0 : y0 + ch, x0 : x0 + cw]),
            focal_px=float(projector.focal[i]) * scale,
            invz_min=float(projector.invz_min[i]),
            invz_max=float(projector.invz_max[i]),
        ))
    return _stack_layers(
        layers,
        skew=np.asarray(projector.skew),
        position=np.asarray(projector.position),
        rotation=np.asarray(projector.rotation),
        baseline=float(projector.baseline),
    )
