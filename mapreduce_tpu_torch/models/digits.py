"""Synthetic 16x16 digit-glyph dataset (a copy of
``mapreduce_tpu/models/digits.py``: numpy only, so one seed gives the JAX
package's arrays bit for bit).

Stands in for the reference's ``misc/digits.png`` (a 16x16 glyph grid cut
into 800 train + 200 validation patterns, examples/APRIL-ANN/init.lua:
82-115), which is binary test data we neither have nor copy.  Digits are
rendered as 7-segment-style glyphs with random sub-pixel jitter and noise,
deterministically from a seed — structured enough that the MLP's learning
curve means something, and self-contained.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

# 7-segment encoding per digit: (top, top-left, top-right, middle,
# bottom-left, bottom-right, bottom)
_SEGMENTS = {
    0: (1, 1, 1, 0, 1, 1, 1),
    1: (0, 0, 1, 0, 0, 1, 0),
    2: (1, 0, 1, 1, 1, 0, 1),
    3: (1, 0, 1, 1, 0, 1, 1),
    4: (0, 1, 1, 1, 0, 1, 0),
    5: (1, 1, 0, 1, 0, 1, 1),
    6: (1, 1, 0, 1, 1, 1, 1),
    7: (1, 0, 1, 0, 0, 1, 0),
    8: (1, 1, 1, 1, 1, 1, 1),
    9: (1, 1, 1, 1, 0, 1, 1),
}


def _glyph(digit: int) -> np.ndarray:
    """Render one 16x16 glyph (float32 in [0,1])."""
    img = np.zeros((16, 16), dtype=np.float32)
    top, tl, tr, mid, bl, br, bot = _SEGMENTS[digit]
    x0, x1 = 3, 12
    y_top, y_mid, y_bot = 2, 7, 13
    if top:
        img[y_top, x0:x1 + 1] = 1.0
    if mid:
        img[y_mid, x0:x1 + 1] = 1.0
    if bot:
        img[y_bot, x0:x1 + 1] = 1.0
    if tl:
        img[y_top:y_mid + 1, x0] = 1.0
    if tr:
        img[y_top:y_mid + 1, x1] = 1.0
    if bl:
        img[y_mid:y_bot + 1, x0] = 1.0
    if br:
        img[y_mid:y_bot + 1, x1] = 1.0
    return img


def make_digits(n_train: int = 800, n_val: int = 200, seed: int = 0,
                noise: float = 0.15,
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Returns ``(x_train [N,256], y_train [N], x_val, y_val)`` float32 /
    int32, classes balanced round-robin like the reference's glyph grid."""
    rng = np.random.default_rng(seed)
    glyphs = np.stack([_glyph(d) for d in range(10)])

    def batch(n: int):
        ys = np.arange(n, dtype=np.int32) % 10
        xs = np.empty((n, 16, 16), dtype=np.float32)
        for i, y in enumerate(ys):
            img = glyphs[y]
            # random 1-pixel shifts + blur-ish jitter + noise
            sx, sy = rng.integers(-1, 2, size=2)
            img = np.roll(np.roll(img, sx, axis=1), sy, axis=0)
            img = img + rng.normal(0.0, noise, size=img.shape)
            xs[i] = np.clip(img, 0.0, 1.0)
        perm = rng.permutation(n)
        return xs[perm].reshape(n, 256), ys[perm]

    x_tr, y_tr = batch(n_train)
    x_va, y_va = batch(n_val)
    return x_tr, y_tr, x_va, y_va
