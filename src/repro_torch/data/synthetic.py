"""Synthetic data: CelebA-like images and language-model token streams.

Copies of ``SyntheticCelebA``, ``synthetic_lm_batch`` and
``synthetic_batch_for_config`` from ``repro/data/synthetic.py`` (numpy
only, the same draws from the same generator, so both packages see the
same data). The images: 32 x 32 x 3 with a binary attribute ("smiling")
realized as a localized curvature pattern in the mouth region,
standardized like the paper's preprocessing; learnable by the paper's
4-layer CNN, absolute accuracy not comparable to real CelebA. The tokens:
a Zipf-ish Markov stream for the decoders.
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


def synthetic_lm_batch(rng: np.random.Generator, batch: int, seq: int,
                       vocab: int, codebooks: int = 0) -> Dict[str, np.ndarray]:
    """Zipf-ish Markov token stream: next ~ (prev + step) mod vocab with noise."""
    shape = (batch, seq + 1, codebooks) if codebooks else (batch, seq + 1)
    steps = rng.integers(1, 7, size=shape[:1])
    toks = np.zeros(shape, np.int32)
    toks[:, 0] = rng.integers(0, vocab, size=shape[:1] + shape[2:])
    noise = rng.random(shape) < 0.1
    for t in range(1, seq + 1):
        nxt = (toks[:, t - 1] + steps.reshape((-1,) + (1,) * (toks.ndim - 2))) % vocab
        rand = rng.integers(0, vocab, size=nxt.shape)
        toks[:, t] = np.where(noise[:, t], rand, nxt)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def check_seq(cfg, seq: int) -> None:
    """Raise ``ValueError`` unless ``seq`` exceeds a VLM's prefix: its
    sequence is ``n_prefix_embeddings`` patch embeddings and then seq -
    prefix text tokens (the reference fails there inside numpy)."""
    if cfg.modality == "vlm" and seq <= cfg.n_prefix_embeddings:
        raise ValueError(
            f"{cfg.arch_id}: sequence length {seq} must exceed its "
            f"{cfg.n_prefix_embeddings} prefix patch embeddings "
            "(n_prefix_embeddings): the text span is seq - prefix")


def synthetic_batch_for_config(cfg, rng: np.random.Generator, batch: int,
                               seq: int) -> Dict[str, np.ndarray]:
    """A training batch matching the arch's input contract (frontends
    stubbed); ``cfg`` is a ``models.config.ModelConfig``. A VLM's ``seq``
    counts its prefix (``check_seq``)."""
    check_seq(cfg, seq)
    if cfg.modality == "audio":
        return synthetic_lm_batch(rng, batch, seq, cfg.vocab, cfg.audio_codebooks)
    if cfg.modality == "vlm":
        s_text = seq - cfg.n_prefix_embeddings
        b = synthetic_lm_batch(rng, batch, s_text, cfg.vocab)
        b["patch_embeddings"] = rng.normal(
            0.0, 1.0, size=(batch, cfg.n_prefix_embeddings, cfg.d_model)).astype(np.float32)
        return b
    return synthetic_lm_batch(rng, batch, seq, cfg.vocab)
