"""Device ops (``crnn_ocr_tpu/ops/``): the CTC loss and decoders, edit
distance, the affine warp and preprocessing, under the JAX package's
names. Importing builds and loads no kernel: each kernel library is built
at its first launch."""

from crnn_ocr_torch.ops import ctc, editdistance, grid_sample, preprocess
from crnn_ocr_torch.ops.ctc import (
    ctc_batch_cost,
    ctc_beam_search_decode,
    ctc_decode,
    ctc_forced_alignment,
    ctc_greedy_alignment,
    ctc_greedy_decode,
    ctc_loss_from_log_probs,
)
from crnn_ocr_torch.ops.editdistance import (
    batched_levenshtein,
    cer_sums_on_device,
)
from crnn_ocr_torch.ops.grid_sample import (
    affine_grid,
    bilinear_sample,
    grid_sample_affine,
)
from crnn_ocr_torch.ops.preprocess import (
    pack_canvas,
    preprocess_batch,
    preprocess_host,
)

__all__ = [
    "affine_grid",
    "batched_levenshtein",
    "bilinear_sample",
    "cer_sums_on_device",
    "ctc",
    "editdistance",
    "ctc_batch_cost",
    "ctc_beam_search_decode",
    "ctc_decode",
    "ctc_forced_alignment",
    "ctc_greedy_alignment",
    "ctc_greedy_decode",
    "ctc_loss_from_log_probs",
    "grid_sample",
    "grid_sample_affine",
    "pack_canvas",
    "preprocess",
    "preprocess_batch",
    "preprocess_host",
]
