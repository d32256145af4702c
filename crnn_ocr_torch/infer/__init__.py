from crnn_ocr_torch.infer.predictor import Prediction, Predictor
from crnn_ocr_torch.infer.pretrained import load_pretrained

__all__ = ["Prediction", "Predictor", "load_pretrained"]
