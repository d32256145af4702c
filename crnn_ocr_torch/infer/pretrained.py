"""Bundled pretrained models (``crnn_ocr_tpu/infer/pretrained.py``).

The config, the class map and the Keras ``.h5`` weights are read from the
JAX package's ``crnn_ocr_tpu/pretrained/<dir>/`` (the weights through the
port's own HDF5 reader, ``infer/hdf5.py``).

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
    import_keras_h5,
    params_from_jax,
)

REGISTRY = {
    "fonts-small": "fonts_small",
    "fonts-hard": "fonts_hard",
    # STN models: fixed width (their localization Dense), bucket 256 only
    "fonts-stn": "fonts_stn",
    "fonts-warp-stn": "fonts_warp_stn",
}


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
            f"(have {sorted(REGISTRY)})")
    d = REGISTRY[name]
    src = os.path.join(JAX_PRETRAINED, d)
    cfg = load_model_config(os.path.join(src, "model_config.json"))
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    codec = LabelCodec.load(os.path.join(src, "classes.json"))
    params, stats = import_keras_h5(os.path.join(src, "weights.h5"), cfg)
    return Predictor(cfg, params_from_jax(params, stats), codec,
                     device=device, **kw)
