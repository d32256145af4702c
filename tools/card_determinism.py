"""Are two straight training runs on the card bit for bit the same?

    python3 tools/card_determinism.py

A narrow BiGRU CRNN (f32, dropout 0.1, the card tests' shape:
``tests/test_torch_cuda.py::_corpus_setup``) fits over a corpus of 24
synthetic lines held on the card with half its rows resident, K = 2 steps
a call, augmented: 1 step and 8 steps, each run twice from the same seed,
under three settings, each added to the one before: PyTorch's defaults,
``torch.backends.cudnn.deterministic``, and
``torch.use_deterministic_algorithms`` (with
``CUBLAS_WORKSPACE_CONFIG=:4096:8``). Prints the card's ``name,
power.limit``, then one JSON line per setting: how many of the state's
tensors (parameters, BatchNorm statistics, optimizer slots) differ
between the two runs, and the first few with their largest difference.
Needs a CUDA card and ``cv2``; the corpus goes to a temporary directory.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from crnn_ocr_torch.config import ModelConfig  # noqa: E402
from crnn_ocr_torch.data.device_cache import DeviceResidentCorpus  # noqa
from crnn_ocr_torch.data.reader import Reader, ReaderConfig  # noqa: E402
from crnn_ocr_torch.data.synthetic import (  # noqa: E402
    SyntheticConfig,
    SyntheticTextlines,
)
from crnn_ocr_torch.train import FitConfig, create_train_state, fit  # noqa

CFG = ModelConfig(num_classes=10, width=128, stem_filters=8,
                  block_filters=(8, 8, 12, 12), time_dense_size=16,
                  n_units=32, rnn_layers=1, dropout_rate=0.1)


def corpus(d: str) -> DeviceResidentCorpus:
    import cv2

    synth = SyntheticTextlines(SyntheticConfig(alphabet="0123456789",
                                               min_len=2, max_len=4))
    rng = np.random.default_rng(5)
    rows = []
    for i in range(24):
        images, texts = synth.sample_batch(1, rng)
        cv2.imwrite(os.path.join(d, f"l{i}.png"), images[0])
        rows.append(f"l{i}.png\t{texts[0]}")
    with open(os.path.join(d, "annotation.txt"), "w") as f:
        f.write("\n".join(rows))
    reader = Reader(ReaderConfig(path=d, batch_size=4, val_fraction=0.0,
                                 buckets=(128,), max_label_len=8,
                                 pack_cache=True))
    # the tables and half of the 24 x 32 x 128 pixels
    return DeviceResidentCorpus(reader, max_bytes=960 + 24 * 32 * 64,
                                device="cuda")


def tensors(state) -> dict:
    out = {f"model/{k}": v for k, v in state.model.state_dict().items()}
    for i, slots in state.optimizer.state_dict()["state"].items():
        out.update({f"optimizer/{i}/{k}": v for k, v in slots.items()})
    return out


def differ(a, b) -> dict:
    ta, tb = tensors(a), tensors(b)
    bad = [[k, float((ta[k].float() - tb[k].float()).abs().max())]
           for k in ta if not torch.equal(ta[k], tb[k])]
    return dict(tensors_differing=len(bad), first=bad[:4])


def main() -> int:
    if not torch.cuda.is_available():
        print("card_determinism: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    with tempfile.TemporaryDirectory() as d:
        c = corpus(d)

        def run(steps, k):
            state = create_train_state(CFG, seed=0, device="cuda")
            return fit(state, CFG, c.stacked_index_batches(k),
                       cfg=FitConfig(steps=steps, log_every=10 ** 6,
                                     steps_per_call=k, device_corpus=c,
                                     augment=True, augment_seed=4))

        settings = (
            ("defaults", lambda: None),
            ("cudnn.deterministic",
             lambda: setattr(torch.backends.cudnn, "deterministic", True)),
            ("use_deterministic_algorithms",
             lambda: torch.use_deterministic_algorithms(True)))
        for name, setup in settings:
            setup()
            print(json.dumps({"setting": name,
                              "one_step": differ(run(1, 1), run(1, 1)),
                              "eight_steps": differ(run(8, 2), run(8, 2))}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
