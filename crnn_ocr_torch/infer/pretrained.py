"""Bundled pretrained models (``crnn_ocr_tpu/infer/pretrained.py``).

The config and the class map are read from the JAX package's
``crnn_ocr_tpu/pretrained/<dir>/``; the weights from the port's
``crnn_ocr_torch/pretrained/<dir>.npz`` (see ``infer/weights.py``).

    from crnn_ocr_torch import load_pretrained
    predictor = load_pretrained("fonts-small")          # on the card
    print(predictor.predict_text([gray_uint8_image]))
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

from crnn_ocr_torch.config import load_model_config
from crnn_ocr_torch.data.codec import LabelCodec
from crnn_ocr_torch.infer.predictor import Predictor
from crnn_ocr_torch.infer.weights import (
    JAX_PRETRAINED,
    NPZ_DIR,
    load_npz,
    params_from_jax,
)

REGISTRY = {
    "fonts-small": "fonts_small",
    "fonts-hard": "fonts_hard",
}
# Bundled with the JAX package, but their STN front end is not ported yet.
NOT_PORTED = ("fonts-stn", "fonts-warp-stn")


def load_pretrained(
    name: str = "fonts-small",
    device="cuda",
    dtype: Optional[str] = None,
    **kw,
) -> Predictor:
    """A ``Predictor`` for a bundled model. ``dtype`` ("float32" or
    "bfloat16") replaces the shipped compute dtype; other keywords go to
    ``Predictor``."""
    if name not in REGISTRY:
        raise NotImplementedError(
            f"pretrained model {name!r} is not available in the port "
            f"(have {sorted(REGISTRY)}"
            + ("; its STN front end is not ported yet)"
               if name in NOT_PORTED else ")")
        )
    d = REGISTRY[name]
    src = os.path.join(JAX_PRETRAINED, d)
    cfg = load_model_config(os.path.join(src, "model_config.json"))
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    codec = LabelCodec.load(os.path.join(src, "classes.json"))
    params, stats = load_npz(os.path.join(NPZ_DIR, f"{d}.npz"))
    return Predictor(cfg, params_from_jax(params, stats), codec,
                     device=device, **kw)
