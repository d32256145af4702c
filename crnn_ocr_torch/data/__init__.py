from crnn_ocr_torch.data.codec import LabelCodec, default_ocr_codec
from crnn_ocr_torch.data.fontgen import FontConfig, FontTextlines
from crnn_ocr_torch.data.packed import PackedCache
from crnn_ocr_torch.data.pipeline import device_batches, synthetic_batches
from crnn_ocr_torch.data.reader import Reader, ReaderConfig
from crnn_ocr_torch.data.synthetic import SyntheticConfig, SyntheticTextlines

__all__ = [
    "FontConfig",
    "FontTextlines",
    "LabelCodec",
    "default_ocr_codec",
    "PackedCache",
    "Reader",
    "ReaderConfig",
    "SyntheticConfig",
    "SyntheticTextlines",
    "device_batches",
    "synthetic_batches",
]
