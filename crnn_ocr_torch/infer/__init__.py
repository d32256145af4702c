from crnn_ocr_torch.infer.predictor import (
    CharSpan,
    Prediction,
    Predictor,
    decode_predict_ctc,
    init_predictor,
    predictor_from_cli,
)
from crnn_ocr_torch.infer.pretrained import load_pretrained, pretrained_dir

__all__ = [
    "CharSpan",
    "Prediction",
    "Predictor",
    "decode_predict_ctc",
    "init_predictor",
    "predictor_from_cli",
    "load_pretrained",
    "pretrained_dir",
]
