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
    seeded_rnn_params,
)

REGISTRY = {
    "fonts-small": "fonts_small",
    "fonts-hard": "fonts_hard",
    # STN models: fixed width (their localization Dense), bucket 256 only
    "fonts-stn": "fonts_stn",
    "fonts-warp-stn": "fonts_warp_stn",
}
# Configurations with no weights of their own: a bundled model's trunk and
# head with its BiGRU layers replaced by seeded BiLSTM ones
# (``weights.seeded_rnn_params``): name -> (bundled model, seed). Their
# BiLSTM layers are random, so they read no text; they run the LSTM's path
# at the bundled model's full width and depth. fonts-hard-lstm is what
# ``crnn-ocr-train --rnn lstm`` builds with its defaults (n_units 256,
# time_dense 128, 2 layers) on fonts-hard's task and architecture.
VARIANTS = {"fonts-hard-lstm": ("fonts-hard", 0)}


def pretrained_dir(name: str) -> str:
    """The directory of bundled model ``name``: its ``model_config.json``,
    ``classes.json`` and ``weights.h5``. A variant has none, so it and an
    unknown name raise ``KeyError``, as the JAX package's does."""
    if name not in REGISTRY:
        raise KeyError(f"unknown model {name!r}; have {sorted(REGISTRY)}")
    return os.path.join(JAX_PRETRAINED, REGISTRY[name])


def model_weights(name: str, dtype: Optional[str] = None):
    """``(cfg, params, batch_stats, codec)`` of a bundled model or a variant:
    its config (``dtype`` replacing the shipped compute dtype), its weights
    as the JAX package's numpy trees (``params_from_jax`` maps them onto the
    port's CRNN) and its class map."""
    base, seed = VARIANTS.get(name, (name, None))
    if base not in REGISTRY:
        raise NotImplementedError(
            f"pretrained model {name!r} is not available in the port "
            f"(have {sorted(REGISTRY) + sorted(VARIANTS)})")
    src = pretrained_dir(base)
    cfg = load_model_config(os.path.join(src, "model_config.json"))
    if seed is not None:
        cfg = dataclasses.replace(cfg, rnn_cell="lstm")
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    codec = LabelCodec.load(os.path.join(src, "classes.json"))
    params, stats = import_keras_h5(os.path.join(src, "weights.h5"), cfg)
    if seed is not None:
        params.update(seeded_rnn_params(cfg, seed))
    return cfg, params, stats, codec


def load_pretrained(
    name: str = "fonts-small",
    device="cuda",
    dtype: Optional[str] = None,
    **kw,
) -> Predictor:
    """A ``Predictor`` for a bundled model or a variant. ``dtype``
    ("float32" or "bfloat16") replaces the shipped compute dtype; other
    keywords go to ``Predictor``."""
    cfg, params, stats, codec = model_weights(name, dtype)
    return Predictor(cfg, params_from_jax(params, stats), codec,
                     device=device, **kw)
