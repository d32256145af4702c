"""Model hyperparameters: ``ModelConfig`` and its ``model_config.json`` loader.

A copy of ``crnn_ocr_tpu/models/crnn.py::ModelConfig`` without the JAX
runtime knobs ``use_pallas_rnn`` and ``use_fused_stem``: on the card the
port's stem (serving, and training without an STN) and recurrence always
run through their CUDA kernels, at every shape, and no knob turns them
off. The loader ignores those two keys where a bundled
``model_config.json`` carries them.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Tuple

# Keys of the JAX package's config that select its kernel paths.
_RUNTIME_KNOBS = ("use_pallas_rnn", "use_fused_stem")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """CRNN hyperparameters (the reference's constructor knobs)."""

    num_classes: int = 80  # excluding blank; logits dim = num_classes + 1
    height: int = 32
    width: int = 128  # default bucket width
    stem_filters: int = 64
    block_filters: Tuple[int, ...] = (128, 256, 256, 512)
    # (pool_h, pool_w) per block; the stem pools (2, 2)
    block_pools: Tuple[Tuple[int, int], ...] = ((2, 2), (2, 1), (2, 1), (2, 1))
    time_dense_size: int = 128
    n_units: int = 256
    rnn_layers: int = 2
    rnn_cell: str = "gru"  # "gru" | "lstm"
    dropout_rate: float = 0.2
    use_stn: bool = False
    # frames dropped from the head of the CTC alignment
    ctc_time_slice: int = 2
    dtype: str = "float32"  # compute dtype: "float32" | "bfloat16"
    # "native" (trained by this framework) or "keras_migrated"
    provenance: str = "native"

    @property
    def logits_dim(self) -> int:
        return self.num_classes + 1

    @property
    def blank_index(self) -> int:
        return self.num_classes  # last class, Keras convention

    @property
    def width_downsample(self) -> int:
        d = 2  # stem pool
        for _, pw in self.block_pools:
            d *= pw
        return d

    def time_steps(self, width: int | None = None) -> int:
        return (width or self.width) // self.width_downsample


def load_model_config(path: str) -> ModelConfig:
    """Read a ``model_config.json`` as the JAX package writes it."""
    with open(path) as f:
        d = json.load(f)
    for key in _RUNTIME_KNOBS:
        d.pop(key, None)
    d["block_filters"] = tuple(d["block_filters"])
    d["block_pools"] = tuple(tuple(p) for p in d["block_pools"])
    return ModelConfig(**d)
