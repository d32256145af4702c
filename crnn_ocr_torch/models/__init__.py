from crnn_ocr_torch.models.crnn import CRNN, ModelConfig, build_model
from crnn_ocr_torch.models.rnn import BiRNN
from crnn_ocr_torch.models.stn import STN

__all__ = ["CRNN", "ModelConfig", "build_model", "BiRNN", "STN"]
