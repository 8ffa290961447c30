"""Eval-time image loading: uint8 [size, size, 3] pixels for the device.

A copy of the eval half of the JAX package's ``mgnns_tpu/data/images.py``:
``Warp(size)`` bilinear square resize (reference ``utils/util.py:67-77``) for
real files, and a deterministic synthetic image keyed by the sample id for
missing files or ``backend='synthetic'``.  The ImageNet normalization runs on
the device (:func:`mgnns_tpu_torch.models.mgnns.normalize_image_batch`).
Pillow is imported only by the ``'pil'`` backend.
"""

from __future__ import annotations

import hashlib

import numpy as np


def synthetic_image_uint8(key: str, size: int) -> np.ndarray:
    """Deterministic pseudo-image for a sample id: smooth gradients + coarse
    noise seeded by an md5 of the key, generated at 1/8 resolution and
    upsampled.  Bit-identical to the JAX package's."""
    seed = int(hashlib.md5(key.encode()).hexdigest()[:8], 16)
    g = np.random.default_rng(seed)
    y = np.linspace(0, 1, size, dtype=np.float32)
    base = np.outer(y, y)[..., None] * g.uniform(0.2, 0.8, (1, 1, 3)).astype(np.float32)
    small = max(size // 8, 1)
    factor = -(-size // small)  # ceil: cover any size, then crop
    coarse = g.normal(0, 0.05, (small, small, 3)).astype(np.float32)
    noise = np.repeat(np.repeat(coarse, factor, 0), factor, 1)[:size, :size]
    return (np.clip(base + noise + 0.3, 0.0, 1.0) * 255).astype(np.uint8)


def load_image_uint8(path: str, *, size: int, backend: str = "pil",
                     sample_key: str = "") -> np.ndarray:
    """Decode + warp one image -> [size, size, 3] uint8.  ``backend='pil'``
    falls back to :func:`synthetic_image_uint8` for a missing or corrupt
    file, as the JAX package does."""
    if backend == "pil":
        from PIL import Image

        try:
            with Image.open(path) as im:
                im = im.convert("RGB").resize((size, size), Image.BILINEAR)
                return np.asarray(im, np.uint8)
        except (FileNotFoundError, OSError):
            pass
    return synthetic_image_uint8(sample_key or path, size)
