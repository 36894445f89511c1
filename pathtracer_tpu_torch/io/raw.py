"""Big-endian .raw image dump, byte-compatible with the reference
(internal/app/raw/writer.go:11-35): int32 version major(1), minor(0),
width, height, then float32 RGB triplets."""
from __future__ import annotations

import struct

import numpy as np


def write_raw(path: str, img: np.ndarray) -> None:
    """img: [H, W, 3] float."""
    h, w, _ = img.shape
    with open(path, "wb") as f:
        f.write(struct.pack(">iiii", 1, 0, w, h))
        f.write(img.astype(">f4").tobytes())


def read_raw(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        major, minor, w, h = struct.unpack(">iiii", f.read(16))
        assert (major, minor) == (1, 0), f"unknown raw version {major}.{minor}"
        data = np.frombuffer(f.read(w * h * 12), dtype=">f4")
    return data.reshape(h, w, 3).astype(np.float32)
