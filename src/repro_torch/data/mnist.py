"""Procedural MNIST-like dataset (counterpart of ``repro.data.mnist``; no
download).

Digits 0-9 are rendered from 7x5 glyph bitmaps, upscaled to 28x28, and
perturbed with random shift, shear, intensity and pixel noise and a slight
blur.  Deterministic in the seed: the numpy draws are made in the
reference's order with the reference's calls, so ``make_dataset(n, seed)``
gives the reference's images and labels byte for byte.  Absolute accuracies
differ from real MNIST; the paper's Table II is checked by its orderings.
"""
from __future__ import annotations

import numpy as np

_GLYPHS = {
    0: ["01110", "10001", "10011", "10101", "11001", "10001", "01110"],
    1: ["00100", "01100", "00100", "00100", "00100", "00100", "01110"],
    2: ["01110", "10001", "00001", "00010", "00100", "01000", "11111"],
    3: ["01110", "10001", "00001", "00110", "00001", "10001", "01110"],
    4: ["00010", "00110", "01010", "10010", "11111", "00010", "00010"],
    5: ["11111", "10000", "11110", "00001", "00001", "10001", "01110"],
    6: ["00110", "01000", "10000", "11110", "10001", "10001", "01110"],
    7: ["11111", "00001", "00010", "00100", "01000", "01000", "01000"],
    8: ["01110", "10001", "10001", "01110", "10001", "10001", "01110"],
    9: ["01110", "10001", "10001", "01111", "00001", "00010", "01100"],
}


def _glyph_array(d: int) -> np.ndarray:
    return np.array([[int(c) for c in row] for row in _GLYPHS[d]], np.float32)


def _render(digit: int, rng: np.random.Generator) -> np.ndarray:
    g = _glyph_array(digit)
    # upscale 7x5 -> 21x15 then place on 28x28 canvas with jitter
    up = np.kron(g, np.ones((3, 3), np.float32))
    canvas = np.zeros((28, 28), np.float32)
    oy = rng.integers(0, 28 - up.shape[0] + 1)
    ox = rng.integers(0, 28 - up.shape[1] + 1)
    canvas[oy:oy + up.shape[0], ox:ox + up.shape[1]] = up
    # shear
    shear = rng.uniform(-0.2, 0.2)
    rows = np.arange(28)
    shift = np.round(shear * (rows - 14)).astype(int)
    sheared = np.zeros_like(canvas)
    for r in range(28):
        sheared[r] = np.roll(canvas[r], shift[r])
    # intensity jitter + noise + slight blur
    img = sheared * rng.uniform(0.7, 1.0)
    img = img + rng.normal(0, 0.08, img.shape).astype(np.float32)
    k = np.array([0.25, 0.5, 0.25], np.float32)
    img = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, img)
    return np.clip(img, 0.0, 1.0)


def make_dataset(n: int, seed: int = 0):
    """Returns (images (n, 28, 28, 1) f32, labels (n,) i32)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, n).astype(np.int32)
    imgs = np.stack([_render(int(lab), rng) for lab in labels])[..., None]
    return imgs.astype(np.float32), labels


def batches(images, labels, batch_size: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    n = len(labels)
    while True:
        idx = rng.permutation(n)
        for i in range(0, n - batch_size + 1, batch_size):
            sl = idx[i:i + batch_size]
            yield images[sl], labels[sl]
