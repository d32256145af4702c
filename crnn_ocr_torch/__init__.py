"""crnn_ocr_torch: the CRNN text-line recognizer in PyTorch, with CUDA
kernels written for the H100 (``kernels/csrc``).

A port of ``crnn_ocr_tpu`` (JAX on a TPU), which stays in the repo as the
reference. This package imports neither JAX nor anything of
``crnn_ocr_tpu``; it reads only data files (model configs, class maps and
Keras ``.h5`` weights) from ``crnn_ocr_tpu/pretrained/``. Entry points run on CUDA unless the caller
passes ``device="cpu"``.
"""

from crnn_ocr_torch.config import ModelConfig
from crnn_ocr_torch.infer.predictor import Predictor
from crnn_ocr_torch.infer.pretrained import load_pretrained

__all__ = ["ModelConfig", "Predictor", "load_pretrained"]
