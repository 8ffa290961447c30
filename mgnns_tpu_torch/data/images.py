"""Image loading: uint8 [size, size, 3] pixels for the device.

A copy of the JAX package's ``mgnns_tpu/data/images.py`` (reference
``utils/util.py:67-146``): eval is ``Warp(size)``, a bilinear square resize;
train is ``MultiScaleCrop(size, scales=[1, .875, .75, .66], max_distort=1,
fix_crop)`` then a random horizontal flip, drawn from one ``random.Random``
so both packages crop and flip alike.  A deterministic synthetic image keyed
by the sample id stands in for missing files or ``backend='synthetic'``.  The
ImageNet normalization runs on the device
(:func:`mgnns_tpu_torch.models.mgnns.normalize_image_batch`).  Pillow is
imported only by the ``'pil'`` backend.
"""

from __future__ import annotations

import hashlib
import random

import numpy as np

MULTISCALE_SCALES = (1.0, 0.875, 0.75, 0.66)


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


def warp(pil_img, size: int):
    """Square bilinear resize (reference ``Warp``, ``utils/util.py:67-77``)."""
    from PIL import Image

    return pil_img.resize((size, size), Image.BILINEAR)


def _fill_fix_offset(more_fix_crop: bool, image_w: int, image_h: int, crop_w: int, crop_h: int):
    """Candidate crop anchors (reference ``:123-146``)."""
    w_step = (image_w - crop_w) // 4
    h_step = (image_h - crop_h) // 4
    ret = [(0, 0), (4 * w_step, 0), (0, 4 * h_step), (4 * w_step, 4 * h_step),
           (2 * w_step, 2 * h_step)]
    if more_fix_crop:
        ret += [(0, 2 * h_step), (4 * w_step, 2 * h_step), (2 * w_step, 4 * h_step),
                (2 * w_step, 0), (1 * w_step, 1 * h_step), (3 * w_step, 1 * h_step),
                (1 * w_step, 3 * h_step), (3 * w_step, 3 * h_step)]
    return ret


def multi_scale_crop(pil_img, size: int, rng: random.Random, *,
                     scales=MULTISCALE_SCALES, max_distort: int = 1,
                     more_fix_crop: bool = True):
    """Reference ``MultiScaleCrop.__call__`` (``utils/util.py:89-121``; its
    scale list's ``875`` typo read as the intended 0.875)."""
    from PIL import Image

    image_w, image_h = pil_img.size
    base = min(image_w, image_h)
    crop_sizes = [int(base * s) for s in scales]
    crop_h = [size if abs(x - size) < 3 else x for x in crop_sizes]
    crop_w = [size if abs(x - size) < 3 else x for x in crop_sizes]
    pairs = [(w, h) for i, h in enumerate(crop_h) for j, w in enumerate(crop_w)
             if abs(i - j) <= max_distort]
    cw, ch = rng.choice(pairs)
    ow, oh = rng.choice(_fill_fix_offset(more_fix_crop, image_w, image_h, cw, ch))
    crop = pil_img.crop((ow, oh, ow + cw, oh + ch))
    return crop.resize((size, size), Image.BILINEAR)


def load_image_uint8(path: str, *, size: int, train: bool = False,
                     rng: random.Random | None = None, backend: str = "pil",
                     sample_key: str = "") -> np.ndarray:
    """Decode + transform one image -> [size, size, 3] uint8: warp for eval,
    multi-scale crop then a flip with probability 1/2 for ``train`` (one
    ``rng`` for both).  ``backend='pil'`` falls back to
    :func:`synthetic_image_uint8` for a missing or corrupt file, as the JAX
    package does."""
    if backend == "pil":
        from PIL import Image

        try:
            with Image.open(path) as im:
                im = im.convert("RGB")
                if train:
                    r = rng or random.Random(0)
                    im = multi_scale_crop(im, size, r)
                    if r.random() < 0.5:
                        im = im.transpose(0)  # PIL FLIP_LEFT_RIGHT
                else:
                    im = warp(im, size)
                return np.asarray(im, np.uint8)
        except (FileNotFoundError, OSError):
            pass
    return synthetic_image_uint8(sample_key or path, size)
