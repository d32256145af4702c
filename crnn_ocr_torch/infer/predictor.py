"""Greedy recognition API (``crnn_ocr_tpu/infer/predictor.py:57-292``).

uint8 images -> ``pack_canvas`` -> ``preprocess_batch`` on the device ->
``CRNN`` -> softmax after the first ``ctc_time_slice`` frames ->
``ctc_greedy_decode`` -> text. Beam search and per-character alignment come
with the slice that ports them (ROADMAP queue 1, item 11).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from crnn_ocr_torch.config import ModelConfig
from crnn_ocr_torch.data.codec import LabelCodec
from crnn_ocr_torch.models.crnn import CRNN
from crnn_ocr_torch.ops import ctc
from crnn_ocr_torch.ops.preprocess import pack_canvas, preprocess_batch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU. Raises when CUDA is asked for and absent; never falls back."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev


@dataclasses.dataclass
class Prediction:
    text: str
    score: float
    latency_ms: Optional[float] = None


class Predictor:
    def __init__(
        self,
        model_cfg: ModelConfig,
        state_dict: Dict[str, torch.Tensor],
        codec: LabelCodec,
        normalize: bool = True,
        buckets: Sequence[int] = (64, 128, 192, 256),
        device="cuda",
    ):
        self.cfg = model_cfg
        self.codec = codec
        self.normalize = normalize
        self.device = resolve_device(device)
        # an STN model's localization Dense is bound to the width it was
        # trained at: it serves at that width only (JAX predictor.py:76-81)
        self.buckets = ((model_cfg.width,) if model_cfg.use_stn
                        else tuple(buckets))
        self.model = CRNN(model_cfg)
        self.model.load_state_dict(state_dict)
        self.model.eval().requires_grad_(False).to(self.device)

    def resolve_bucket(
        self, images: Sequence[np.ndarray], bucket: Optional[int] = None
    ) -> int:
        """The smallest bucket that fits the widest height-normalized image,
        else the last bucket (wider images squeeze into it)."""
        if bucket is not None:
            return bucket
        w_need = max(
            int(round(im.shape[1] * self.cfg.height / im.shape[0]))
            for im in (np.asarray(im) for im in images)
        )
        return next((b for b in self.buckets if w_need <= b), self.buckets[-1])

    def preprocess(
        self, images: Sequence[np.ndarray], bucket: Optional[int] = None
    ):
        """Grayscale uint8 images -> (x (B, height, bucket), w_new (B,)) on
        the predictor's device: packed on the host, resized and
        standardized on the device."""
        canvas, hs, ws = pack_canvas(list(images), quantize=True)
        bucket = self.resolve_bucket(images, bucket)
        dev = self.device
        return preprocess_batch(
            torch.from_numpy(canvas).to(dev),
            torch.from_numpy(hs).to(dev),
            torch.from_numpy(ws).to(dev),
            out_h=self.cfg.height,
            out_w=bucket,
            normalize=self.normalize,
        )

    def probs(self, logits: torch.Tensor, w_new: torch.Tensor):
        """Logits -> (probs (B, T, C), input_len (B,)): softmax after the
        first ``ctc_time_slice`` frames, and the frames each line covers."""
        probs = torch.softmax(logits[:, self.cfg.ctc_time_slice:, :], dim=-1)
        T = probs.shape[1]
        input_len = torch.clamp(
            w_new // self.cfg.width_downsample - self.cfg.ctc_time_slice,
            1, T,
        )
        return probs, input_len

    def decode(self, probs: torch.Tensor,
               input_len: torch.Tensor) -> List[Prediction]:
        """Greedy CTC decode on the device, then labels to text on the
        host."""
        decoded, score = ctc.ctc_greedy_decode(probs, input_len)
        rows = ctc.trim_dense(decoded.cpu())
        scores = score[:, 0].cpu().tolist()
        return [Prediction(text=self.codec.labels_to_text(row), score=s)
                for row, s in zip(rows, scores)]

    @torch.inference_mode()
    def predict_probs(
        self, images: Sequence[np.ndarray], bucket: Optional[int] = None
    ):
        """Grayscale uint8 images -> (probs (B, T, C), input_len (B,)), both
        on the predictor's device."""
        x, w_new = self.preprocess(images, bucket)
        return self.probs(self.model(x), w_new)

    def predict(
        self,
        images: Sequence[np.ndarray],
        greedy: bool = True,
        timing: bool = False,
        bucket: Optional[int] = None,
    ) -> List[Prediction]:
        if not greedy:
            raise NotImplementedError(
                "beam search is not ported yet: it comes with the slice "
                "that ports beam search and alignment (ROADMAP queue 1, "
                "item 11)"
            )
        t0 = time.perf_counter()
        out = self.decode(*self.predict_probs(images, bucket=bucket))
        if timing:
            per_line = (time.perf_counter() - t0) * 1e3 / len(out)
            for p in out:
                p.latency_ms = per_line
        return out

    def predict_text(self, images: Sequence[np.ndarray], **kw) -> List[str]:
        return [p.text for p in self.predict(images, **kw)]
