from crnn_ocr_torch.data.codec import LabelCodec

__all__ = ["LabelCodec"]
