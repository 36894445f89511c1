"""PNG output with the standard library only (zlib + struct).

Counterpart of pathtracer_tpu.io.png.write_png (reference writeImagePNG +
clamp, internal/app/tracer/pathtracer.go:32-59). It writes an 8-bit RGB PNG
without Pillow, which the machine with the card does not have.
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
