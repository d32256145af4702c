"""Label codec: text <-> integer labels, and the class map on disk (JSON,
or a reference artifact's pickle).

A copy of ``crnn_ocr_tpu/data/codec.py::LabelCodec`` (the part the
recognition and training paths use). Blank is always ``num_classes``, the last logit,
per the Keras CTC convention.
"""

from __future__ import annotations

import json
from typing import Dict, List, Sequence

import numpy as np


class LabelCodec:
    """Bidirectional char <-> index map."""

    def __init__(self, classes: Dict[str, int]):
        self.classes = dict(classes)
        self.inverse = {v: k for k, v in self.classes.items()}
        if len(self.inverse) != len(self.classes):
            raise ValueError("class map is not a bijection")

    @classmethod
    def from_alphabet(cls, alphabet: str) -> "LabelCodec":
        return cls({c: i for i, c in enumerate(alphabet)})

    @property
    def num_classes(self) -> int:
        return len(self.classes)

    @property
    def blank_index(self) -> int:
        return len(self.classes)

    def text_to_labels(self, text: str, strict: bool = True) -> List[int]:
        """Encode text; with ``strict=False`` unknown chars are dropped."""
        if strict:
            try:
                return [self.classes[c] for c in text]
            except KeyError as e:
                raise KeyError(
                    f"character {e.args[0]!r} not in class map "
                    f"({self.num_classes} classes); use strict=False to drop"
                ) from None
        return [self.classes[c] for c in text if c in self.classes]

    def labels_to_text(self, labels: Sequence[int]) -> str:
        # -1 is dense-decode padding; blank never appears after decoding
        # but is skipped all the same.
        return "".join(
            self.inverse[int(l)]
            for l in labels
            if int(l) >= 0 and int(l) in self.inverse
        )

    def encode_batch(self, texts: Sequence[str], max_len: int | None = None,
                     strict: bool = True):
        """Dense (B, L) int32 labels + (B,) true encoded lengths, 0-padded
        (``crnn_ocr_tpu/data/codec.py:66-79``)."""
        encs = [self.text_to_labels(t, strict=strict) for t in texts]
        lens = np.array([len(e) for e in encs], np.int32)
        L = int(max_len or max(1, lens.max()))
        out = np.zeros((len(texts), L), np.int32)
        for i, enc in enumerate(encs):
            out[i, : min(len(enc), L)] = enc[:L]
        return out, np.minimum(lens, L)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.classes, f, ensure_ascii=False, indent=0)

    @classmethod
    def load(cls, path: str) -> "LabelCodec":
        """A JSON class map, or a reference artifact's pickled one
        (``.pkl``, ``crnn_ocr_tpu/data/codec.py:88-93``). Unpickling runs
        code: load only class maps from a source you trust."""
        if path.endswith(".pkl"):
            import pickle

            with open(path, "rb") as f:
                return cls(pickle.load(f))
        with open(path) as f:
            return cls(json.load(f))
