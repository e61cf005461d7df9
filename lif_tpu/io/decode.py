"""Image decode and texture preparation.

The python analog of the reference's texture pipeline
(reference: src/utils/textureUtils.ts and HoloProjector.ts:215-258):

  * RGB JPEGs are sRGB; sampling in WebGL decodes them to linear light, so
    the arrays we feed the kernels are linear float32.
  * Inverse-depth maps are linear-colourspace; their (first-channel) value
    in [0,1] is the normalized disparity.
  * Masks contribute their RED channel as the alpha of the packed
    depth+mask texture (textureUtils.ts:69-81).
  * All arrays are flipped to GL orientation (row 0 = v=0 = image bottom)
    so the kernels' uv math matches the shaders exactly; I/O boundaries
    flip back.
"""

from __future__ import annotations

import io as _io

import numpy as np


def _srgb_to_linear_np(x: np.ndarray) -> np.ndarray:
    """Numpy sRGB EOTF: decode is host-side, so an eager jnp call here
    would only copy every image to the device and back."""
    return np.where(
        x <= 0.04045, x / 12.92, np.power((x + 0.055) / 1.055, 2.4)
    ).astype(np.float32)

__all__ = [
    "decode_image",
    "image_dimensions",
    "decode_rgb",
    "decode_depth",
    "decode_mask",
    "encode_jpeg",
    "encode_png",
    "to_display",
]


def decode_image(data: bytes) -> np.ndarray:
    """Decode image bytes to a uint8 numpy array (H, W[, C]), top-down."""
    from PIL import Image

    with Image.open(_io.BytesIO(data)) as im:
        return np.asarray(im)


def image_dimensions(data: bytes) -> tuple[int, int]:
    """(width, height) without full decode. reference: LifLoader.ts:425-441."""
    from PIL import Image

    with Image.open(_io.BytesIO(data)) as im:
        return im.width, im.height


def decode_rgb(data: bytes, linear: bool = True) -> np.ndarray:
    """RGB bytes -> (H, W, 3) float32, GL-oriented; linear light by default
    (the WebGL sRGB-texture decode, HoloProjector.ts:223)."""
    arr = decode_image(data)
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    arr = arr[..., :3].astype(np.float32) / 255.0
    arr = arr[::-1].copy()  # GL orientation
    if linear:
        arr = _srgb_to_linear_np(arr)
    return arr


def decode_depth(data: bytes) -> np.ndarray:
    """Inverse-depth bytes -> (H, W) float32 in [0,1], GL-oriented.

    WebGL reads the texture's first channel; depth maps are loaded in
    linear colourspace, so the byte value maps straight to [0,1]
    (HoloProjector.ts:240-258)."""
    arr = decode_image(data)
    if arr.ndim == 3:
        arr = arr[..., 0]
    return (arr.astype(np.float32) / 255.0)[::-1].copy()


def decode_mask(data: bytes | None, shape: tuple[int, int]) -> np.ndarray:
    """Mask bytes -> (H, W) float32 alpha from the RED channel, GL-oriented;
    all-ones when absent. reference: textureUtils.ts:69-81."""
    if data is None:
        return np.ones(shape, dtype=np.float32)
    arr = decode_image(data)
    if arr.ndim == 3:
        arr = arr[..., 0]
    return (arr.astype(np.float32) / 255.0)[::-1].copy()


def encode_jpeg(rgb_linear: np.ndarray, quality: int = 92) -> bytes:
    """(H, W, 3) linear float GL-oriented -> sRGB JPEG bytes (top-down)."""
    from PIL import Image

    x = np.clip(np.asarray(rgb_linear), 0.0, 1.0)
    srgb = np.where(
        x <= 0.0031308, x * 12.92, 1.055 * np.power(x, 1 / 2.4) - 0.055
    )
    img = (np.clip(srgb, 0, 1) * 255).astype(np.uint8)[::-1]
    buf = _io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def encode_png(gray_or_rgb: np.ndarray) -> bytes:
    """(H, W[,3]) float [0,1] GL-oriented -> PNG bytes (top-down)."""
    from PIL import Image

    img = (np.clip(gray_or_rgb, 0, 1) * 255).astype(np.uint8)[::-1]
    buf = _io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return buf.getvalue()


def to_display(image_gl: np.ndarray) -> np.ndarray:
    """Flip a GL-oriented render back to top-down display order."""
    return np.asarray(image_gl)[::-1]
