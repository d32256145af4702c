"""Host metrics and profiling (``crnn_ocr_tpu/utils/``)."""

from crnn_ocr_torch.utils import metrics, profiling
from crnn_ocr_torch.utils.metrics import cer, levenshtein, sequence_accuracy, wer

__all__ = [
    "cer",
    "levenshtein",
    "metrics",
    "profiling",
    "sequence_accuracy",
    "wer",
]
