"""Image grids: the per-epoch sample dumps (port of ``rnagan_tpu/utils/images.py``).

The PNG is written with ``zlib`` and ``struct`` from the standard library
(8-bit RGB or greyscale, filter type 0 on every row), so the port needs no
imaging package.
"""

from __future__ import annotations

import math
import os
import struct
import zlib
from typing import Optional

import numpy as np
import torch


def to_uint8(images) -> np.ndarray:
    """[-1, 1] float NHWC -> uint8 (the inverse of the Normalize(0.5, 0.5)
    input transform, reference ``histopathology_gan.py:106-109``)."""
    if isinstance(images, torch.Tensor):
        images = images.detach().cpu().numpy()
    images = (np.asarray(images, np.float32) * 0.5 + 0.5) * 255.0
    return np.clip(np.round(images), 0, 255).astype(np.uint8)


def _png(canvas: np.ndarray) -> bytes:
    h, w, c = canvas.shape
    color = {1: 0, 3: 2}[c]  # greyscale or truecolour
    raw = b"".join(b"\x00" + canvas[y].tobytes() for y in range(h))

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    header = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def save_image_grid(images, path: str, nrow: Optional[int] = None, pad: int = 2) -> None:
    """Tile NHWC images (float in [-1, 1] or uint8; numpy or torch) into a grid PNG."""
    if isinstance(images, torch.Tensor):
        images = images.detach().cpu().numpy()
    if images.dtype != np.uint8:
        images = to_uint8(images)
    n, h, w, c = images.shape
    nrow = nrow or int(math.ceil(math.sqrt(n)))
    ncol = int(math.ceil(n / nrow))
    canvas = np.zeros((ncol * (h + pad) + pad, nrow * (w + pad) + pad, c), np.uint8)
    for i in range(n):
        r, col = divmod(i, nrow)
        y = pad + r * (h + pad)
        x = pad + col * (w + pad)
        canvas[y:y + h, x:x + w] = images[i]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(_png(canvas))
