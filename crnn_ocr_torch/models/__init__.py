from crnn_ocr_torch.models.crnn import CRNN
from crnn_ocr_torch.models.rnn import BiRNN

__all__ = ["CRNN", "BiRNN"]
