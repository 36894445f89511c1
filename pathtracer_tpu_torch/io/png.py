"""PNG output with the standard library only (zlib + struct), and texture
image loading.

Counterpart of pathtracer_tpu.io.png (reference writeImagePNG + clamp,
internal/app/tracer/pathtracer.go:32-59, and scenes.LoadImage,
internal/app/scenes/scene.go:30-56). The writer needs no Pillow; the
loader imports Pillow when it is called, for real image files found under
the asset path.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np


def clamp_to_u8(img: np.ndarray) -> np.ndarray:
    """Clamp [0,1] floats to bytes like the reference (pathtracer.go:50-59):
    scale by 255 and clip."""
    return np.clip(img * 255.0, 0.0, 255.0).astype(np.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(kind + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", crc)


def write_png(path: str, img: np.ndarray) -> None:
    """img: [H, W, 3] float (linear, unclamped) -> 8-bit RGB PNG."""
    px = clamp_to_u8(np.asarray(img)[..., :3])
    h, w, _ = px.shape
    # filter type 0 (none) in front of every scanline
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), px.reshape(h, w * 3)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_chunk(b"IHDR", ihdr))
        f.write(_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))


def load_image(path: str) -> np.ndarray:
    """Decode PNG/JPEG to [H, W, 3] float32 in [0,1] (scene.go LoadImage
    converts to NRGBA; this normalizes to float)."""
    from PIL import Image

    with Image.open(path) as im:
        arr = np.asarray(im.convert("RGB"), dtype=np.float32) / 255.0
    return arr
