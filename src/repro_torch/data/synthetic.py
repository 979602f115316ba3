"""Synthetic CelebA-like data.

A copy of ``SyntheticCelebA`` from ``repro/data/synthetic.py`` (numpy only,
same seed, same images): 32 x 32 x 3 images with a binary attribute
("smiling") realized as a localized curvature pattern in the mouth region,
standardized like the paper's preprocessing. Learnable by the paper's
4-layer CNN; absolute accuracy is not comparable to real CelebA.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np


@dataclasses.dataclass
class SyntheticCelebA:
    """Deterministic synthetic image-attribute dataset."""

    n_samples: int = 20_000
    image_size: int = 32
    seed: int = 1549775860  # the paper's LEAF partition seed

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        n, s = self.n_samples, self.image_size
        self.labels = rng.integers(0, 2, size=n).astype(np.int32)
        # Face-like base: smooth random blobs per image.
        base = rng.normal(0.0, 1.0, size=(n, s, s, 3)).astype(np.float32)
        for _ in range(2):  # cheap smoothing: average with shifted copies
            base = 0.25 * (base + np.roll(base, 1, 1) + np.roll(base, 1, 2)
                           + np.roll(base, -1, 1))
        # "Smile": an upward-curved bright arc in the lower-center region.
        yy, xx = np.mgrid[0:s, 0:s].astype(np.float32)
        cx, cy = s / 2.0, s * 0.72
        arc_up = np.exp(-(((xx - cx) ** 2) / 18.0 +
                          ((yy - (cy - 2 + ((xx - cx) / 4.0) ** 2)) ** 2) / 2.0))
        arc_dn = np.exp(-(((xx - cx) ** 2) / 18.0 +
                          ((yy - (cy + 2 - ((xx - cx) / 4.0) ** 2)) ** 2) / 2.0))
        amp = rng.uniform(0.8, 1.6, size=(n, 1, 1)).astype(np.float32)
        pattern = np.where(self.labels[:, None, None] == 1, arc_up[None],
                           arc_dn[None])
        base[..., 0] += amp * pattern
        base[..., 1] += 0.5 * amp * pattern
        # Normalize to mean 0.5 / std 0.5 convention -> standardized tensor.
        base = (base - base.mean()) / (base.std() + 1e-6)
        self.images = base.astype(np.float32)

    def batch(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        return {"images": self.images[idx], "labels": self.labels[idx]}
