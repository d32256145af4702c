"""Synthetic text-line image generator (deterministic glyph atlas).

A copy of ``crnn_ocr_tpu/data/synthetic.py`` (numpy only): the same seed
gives the same images and texts.

The reference trains on IAM words / license plates from disk; those corpora
aren't available in this environment, so integration tests and benchmarks use
a synthetic task with the same shape: render a string as a horizontal strip
of per-character glyphs. Glyphs are random-but-fixed binary patterns (no font
dependency), which makes the task fully learnable — a correct train loop
drives CER to ~0 within a few hundred steps (SURVEY.md §4 "integration").

Optional augmentations mirror the reference's qualitative pipeline (slight
affine jitter, noise, contrast).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from crnn_ocr_torch.data.codec import LabelCodec


@dataclasses.dataclass
class SyntheticConfig:
    alphabet: str = "0123456789abcdefghijklmnopqrstuvwxyz"
    glyph_height: int = 24
    glyph_width: int = 12
    min_len: int = 2
    max_len: int = 10
    image_height: int = 32  # canvas height (glyphs vertically centered)
    augment: bool = False
    noise: float = 0.05
    seed: int = 0


class SyntheticTextlines:
    """Deterministic renderer + sampler."""

    def __init__(self, cfg: SyntheticConfig | None = None):
        self.cfg = cfg or SyntheticConfig()
        c = self.cfg
        self.codec = LabelCodec.from_alphabet(c.alphabet)
        atlas_rng = np.random.default_rng(c.seed + 12345)
        # fixed per-char glyphs: blotchy binary patterns, distinct per char
        self.atlas = (
            atlas_rng.random((len(c.alphabet), c.glyph_height, c.glyph_width))
            < 0.35
        ).astype(np.uint8)

    def render(self, text: str, rng: np.random.Generator | None = None):
        c = self.cfg
        glyphs = [self.atlas[self.codec.classes[ch]] for ch in text]
        strip = np.concatenate(glyphs, axis=1)  # (gh, gw*len)
        h, w = c.image_height, strip.shape[1] + 8
        img = np.full((h, w), 255, np.uint8)
        y0 = (h - c.glyph_height) // 2
        img[y0 : y0 + c.glyph_height, 4 : 4 + strip.shape[1]] = np.where(
            strip > 0, 30, 255
        ).astype(np.uint8)
        if c.augment and rng is not None:
            img = self._augment(img, rng)
        return img

    def _augment(self, img: np.ndarray, rng: np.random.Generator):
        c = self.cfg
        out = img.astype(np.float32)
        # brightness/contrast jitter
        out = out * rng.uniform(0.85, 1.1) + rng.uniform(-15, 15)
        # speckle noise
        out += rng.normal(0, 255 * c.noise, size=out.shape)
        # horizontal shear (cheap affine)
        shear = rng.uniform(-0.1, 0.1)
        h, w = out.shape
        ys = np.arange(h)
        shift = (shear * (ys - h / 2)).astype(np.int32)
        rows = [np.roll(out[y], shift[y]) for y in range(h)]
        out = np.stack(rows)
        return np.clip(out, 0, 255).astype(np.uint8)

    def sample_batch(
        self, batch_size: int, rng: np.random.Generator
    ) -> Tuple[List[np.ndarray], List[str]]:
        c = self.cfg
        texts = []
        for _ in range(batch_size):
            n = int(rng.integers(c.min_len, c.max_len + 1))
            idx = rng.integers(0, len(c.alphabet), n)
            texts.append("".join(c.alphabet[i] for i in idx))
        images = [
            self.render(t, rng if c.augment else None) for t in texts
        ]
        return images, texts
