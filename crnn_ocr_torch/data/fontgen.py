"""Font-rendered text lines: a training corpus without a corpus.

A copy of ``crnn_ocr_tpu/data/fontgen.py`` (``FontConfig``,
``FontTextlines``): real text rendered with TrueType fonts (PIL and the
DejaVu families shipped inside matplotlib), mjsynth style: a random word,
font and size, a jittered baseline, optional degradations (blur, contrast,
resolution loss) and geometric warps (shear, rotation, perspective), light
noise. For the same text, configuration and rng state a render is
byte-identical to the JAX package's.

It runs on the host only and needs PIL and matplotlib's fonts, both
imported where used; a machine without them cannot build
``FontTextlines``.
"""

from __future__ import annotations

import dataclasses
import glob
import os
from typing import List, Optional, Tuple

import numpy as np

from crnn_ocr_torch.data.codec import LabelCodec

# a small embedded vocabulary (no corpus files needed); mixed case +
# digits exercise the full alphabet
_WORDS = (
    "the quick brown fox jumps over lazy dog pack my box with five dozen "
    "liquor jugs how vexingly daft zebras judge sphinx of black quartz my "
    "vow time year people way day man thing woman life child world school "
    "state family student group country problem hand part place case week "
    "company system program question work government number night point "
    "home water room mother area money story fact month lot right study "
    "book eye job word business issue side kind head house service friend "
    "father power hour game line end member law car city community name "
    "team minute idea body information back parent face others level "
    "office door health person art war history party result change morning "
    "reason research girl guy moment air teacher force education"
).split()


def _default_fonts() -> List[str]:
    try:
        import matplotlib

        d = os.path.join(
            os.path.dirname(matplotlib.__file__), "mpl-data", "fonts", "ttf"
        )
        fonts = [
            f
            for f in glob.glob(os.path.join(d, "*.ttf"))
            if "Display" not in f and "cm" not in os.path.basename(f)[:2]
        ]
        preferred = [
            f
            for f in fonts
            if any(
                k in os.path.basename(f)
                for k in ("DejaVuSans.", "DejaVuSerif.", "DejaVuSansMono.",
                          "DejaVuSans-Bold", "DejaVuSerif-Bold")
            )
        ]
        return preferred or fonts
    except Exception:
        return []


@dataclasses.dataclass
class FontConfig:
    alphabet: str = (
        "0123456789abcdefghijklmnopqrstuvwxyz"
        "ABCDEFGHIJKLMNOPQRSTUVWXYZ"
    )
    min_words: int = 1
    max_words: int = 2
    min_size: int = 18
    max_size: int = 26
    height: int = 32
    digits_fraction: float = 0.2  # fraction of samples that are digit strings
    capitalize_fraction: float = 0.3
    noise: float = 0.02
    # degradations (all off by default): combined they produce tasks with
    # IRREDUCIBLE ambiguity — trained models plateau at nonzero CER, the
    # regime the reference's real corpora (IAM scans, plate photos) live in
    blur: float = 0.0  # Gaussian blur radius, sampled U[0, blur]
    contrast_min: float = 1.0  # ink/paper span factor, sampled U[min, 1]
    downscale_min: float = 1.0  # resolution loss: render -> xS down -> up
    # render-time GEOMETRIC distortion (deliberately distinct from the
    # model-side --augment warp, which both arms of an STN A/B would see):
    # the line is photographed off-axis, the way the reference's
    # license-plate crops are (SURVEY C5 / BASELINE config 3). Applied
    # before the photometric degradations, like a real camera pipeline.
    warp_shear: float = 0.0  # max |horizontal shear| (dx per unit y)
    warp_rotate: float = 0.0  # max |rotation| in degrees
    warp_perspective: float = 0.0  # max corner jitter, fraction of height
    seed: int = 0


class FontTextlines:
    """PIL-rendered word images; API-compatible with SyntheticTextlines."""

    def __init__(self, cfg: Optional[FontConfig] = None):
        from PIL import ImageFont

        self.cfg = cfg or FontConfig()
        self.codec = LabelCodec.from_alphabet(self.cfg.alphabet)
        paths = _default_fonts()
        if not paths:
            raise RuntimeError("no TrueType fonts found (matplotlib missing?)")
        self._fonts = {}
        for p in paths:
            for size in range(self.cfg.min_size, self.cfg.max_size + 1, 2):
                self._fonts[(p, size)] = ImageFont.truetype(p, size)
        self._font_keys = sorted(self._fonts)

    def _sample_text(self, rng: np.random.Generator) -> str:
        c = self.cfg
        if rng.random() < c.digits_fraction:
            n = int(rng.integers(2, 9))
            return "".join(str(d) for d in rng.integers(0, 10, n))
        n_words = int(rng.integers(c.min_words, c.max_words + 1))
        words = [
            _WORDS[int(rng.integers(0, len(_WORDS)))] for _ in range(n_words)
        ]
        text = " ".join(words) if " " in c.alphabet else "".join(words)
        if rng.random() < c.capitalize_fraction:
            text = text.capitalize() if rng.random() < 0.7 else text.upper()
        return "".join(ch for ch in text if ch in self.codec.classes) or "a"

    def _warp(self, img, rng: np.random.Generator):
        """Random shear + rotation + perspective of the rendered line.

        Picks a destination quadrilateral for the image corners, sizes the
        output canvas to its exact bounding box (no clipping, white fill),
        and resamples through the inverse homography
        (``PIL.Image.transform(PERSPECTIVE)`` maps output->input)."""
        import math

        from PIL import Image

        c = self.cfg
        w0, h0 = img.size
        src = np.array(
            [[0, 0], [w0, 0], [w0, h0], [0, h0]], dtype=np.float64
        )
        dst = src.copy()
        if c.warp_shear > 0.0:
            s = float(rng.uniform(-c.warp_shear, c.warp_shear))
            dst[:, 0] += s * (h0 - dst[:, 1])  # top edge slides, bottom fixed
        if c.warp_rotate > 0.0:
            th = math.radians(float(rng.uniform(-c.warp_rotate, c.warp_rotate)))
            ctr = dst.mean(axis=0)
            rot = np.array(
                [[math.cos(th), -math.sin(th)], [math.sin(th), math.cos(th)]]
            )
            dst = (dst - ctr) @ rot.T + ctr
        if c.warp_perspective > 0.0:
            dst += rng.uniform(
                -c.warp_perspective * h0, c.warp_perspective * h0, (4, 2)
            )
        lo = dst.min(axis=0)
        dst -= lo
        out_w = max(4, int(math.ceil(dst[:, 0].max())))
        out_h = max(4, int(math.ceil(dst[:, 1].max())))
        # homography coefficients mapping output (dst) -> input (src)
        A, b = [], []
        for (X, Y), (x, y) in zip(dst, src):
            A.append([X, Y, 1, 0, 0, 0, -x * X, -x * Y])
            A.append([0, 0, 0, X, Y, 1, -y * X, -y * Y])
            b += [x, y]
        coeffs = np.linalg.solve(np.array(A), np.array(b))
        return img.transform(
            (out_w, out_h),
            Image.PERSPECTIVE,
            tuple(coeffs),
            resample=Image.BILINEAR,
            fillcolor=255,
        )

    def render(self, text: str, rng: np.random.Generator) -> np.ndarray:
        from PIL import Image, ImageDraw

        c = self.cfg
        key = self._font_keys[int(rng.integers(0, len(self._font_keys)))]
        font = self._fonts[key]
        bbox = font.getbbox(text)
        tw = max(bbox[2] - bbox[0], 4)
        th = max(bbox[3] - bbox[1], 4)
        pad_x = int(rng.integers(2, 10))
        pad_y = int(rng.integers(0, 5))
        img = Image.new("L", (tw + 2 * pad_x, th + 2 * pad_y + 4), 255)
        ImageDraw.Draw(img).text(
            (pad_x - bbox[0], pad_y - bbox[1]), text, font=font, fill=0
        )
        if c.warp_shear > 0.0 or c.warp_rotate > 0.0 or c.warp_perspective > 0.0:
            img = self._warp(img, rng)
        if c.downscale_min < 1.0:
            s = float(rng.uniform(c.downscale_min, 1.0))
            w0, h0 = img.size
            small = img.resize(
                (max(1, int(w0 * s)), max(1, int(h0 * s))), Image.BILINEAR
            )
            img = small.resize((w0, h0), Image.BILINEAR)
        if c.blur > 0.0:
            from PIL import ImageFilter

            img = img.filter(
                ImageFilter.GaussianBlur(float(rng.uniform(0.0, c.blur)))
            )
        arr = np.asarray(img, dtype=np.float32)
        if c.contrast_min < 1.0:
            # squeeze the ink-paper span toward paper white: gray ink on a
            # bright page, the dominant failure mode of real scans
            f = float(rng.uniform(c.contrast_min, 1.0))
            arr = 255.0 - (255.0 - arr) * f
        if c.noise:
            arr = arr + rng.normal(0, 255 * c.noise, arr.shape)
        return np.clip(arr, 0, 255).astype(np.uint8)

    def sample_batch(
        self, batch_size: int, rng: np.random.Generator
    ) -> Tuple[List[np.ndarray], List[str]]:
        texts = [self._sample_text(rng) for _ in range(batch_size)]
        images = [self.render(t, rng) for t in texts]
        return images, texts
