"""Write the greedy-recognition goldens that the PyTorch port is held to.

Renders text lines with ``crnn_ocr_tpu.data.fontgen`` at each bundled
model's own task, runs them through the JAX ``Predictor`` on the CPU and
stores the images, the true texts and the JAX texts and scores in
``crnn_ocr_torch/testdata/greedy_goldens.npz``. The port's tests and
``chip_smoke.py`` read that file; neither imports JAX.

Per model, under the prefix ``hard_`` (``fonts-hard``) or ``small_``
(``fonts-small``):

* ``canvas`` (N, Hmax, Wmax) uint8, white beyond each image's
  ``heights``/``widths``; ``truth``: the rendered strings.
* ``texts_f32``/``scores_f32``: the JAX predictor with ``dtype`` forced to
  float32 (the XLA stem and the ``lax.scan`` recurrence, all f32).
* ``hard_texts_bf16``/``hard_scores_bf16``: ``fonts-hard`` as shipped
  (bf16), through both Pallas serve kernels in interpret mode
  (``fused_stem_serve`` and ``bigru_pallas_raw``) -- the bf16 rounding
  points that the port's CUDA kernels copy.

Run from the repo root (several minutes on the CPU):

    JAX_PLATFORMS=cpu python tools/gen_torch_goldens.py
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
OUT = os.path.join(REPO, "crnn_ocr_torch", "testdata", "greedy_goldens.npz")

N_LINES = 64
# Each model's own training task (fonts-hard: the FontConfig that
# benchmarks/beam_value_eval_fonts_hard.json records; fonts-small: the
# defaults of tools/beam_value_eval.py), width-filtered to the bucket.
TASKS = {
    "hard": dict(
        model="fonts-hard", bucket=256, seed=20261,
        font=dict(noise=0.12, min_words=2, max_words=3, min_size=12,
                  max_size=20, blur=1.2, contrast_min=0.35,
                  downscale_min=0.5),
    ),
    "small": dict(
        model="fonts-small", bucket=128, seed=20262,
        font=dict(noise=0.06, min_words=1, max_words=2),
    ),
}


def render(font_kw: dict, bucket: int, seed: int):
    from crnn_ocr_tpu.data.fontgen import FontConfig, FontTextlines

    synth = FontTextlines(FontConfig(**font_kw))
    rng = np.random.default_rng(seed)
    images, texts = [], []
    while len(images) < N_LINES:
        imgs, txts = synth.sample_batch(N_LINES, rng)
        for img, t in zip(imgs, txts):
            h, w = img.shape
            if round(w * 32 / h) <= bucket and len(images) < N_LINES:
                images.append(img)
                texts.append(t)
    return images, texts


def jax_predict(name: str, images, dtype: str, pallas: bool):
    from crnn_ocr_tpu.infer import load_pretrained
    from crnn_ocr_tpu.infer.predictor import Predictor
    from crnn_ocr_tpu.models import CRNN

    base = load_pretrained(name)
    cfg = dataclasses.replace(
        base.cfg, dtype=dtype, use_pallas_rnn=pallas, use_fused_stem=pallas
    )
    pred = Predictor(cfg, base._vars["params"], base._vars["batch_stats"],
                     base.codec)
    if pallas:
        # the forward closure reads pred._model when it traces
        pred._model = CRNN(cfg=cfg, pallas_interpret=True)
    out = pred.predict(images)
    return [p.text for p in out], np.array([p.score for p in out], np.float32)


def main() -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    from crnn_ocr_tpu.ops.preprocess import pack_canvas

    arrays = {}
    for key, task in TASKS.items():
        images, truth = render(task["font"], task["bucket"], task["seed"])
        canvas, hs, ws = pack_canvas(images)
        arrays[f"{key}_canvas"] = canvas
        arrays[f"{key}_heights"] = hs
        arrays[f"{key}_widths"] = ws
        arrays[f"{key}_truth"] = np.array(truth)
        texts, scores = jax_predict(task["model"], images, "float32", False)
        arrays[f"{key}_texts_f32"] = np.array(texts)
        arrays[f"{key}_scores_f32"] = scores
        acc = np.mean([a == b for a, b in zip(texts, truth)])
        print(f"{task['model']} f32: line accuracy vs truth {acc:.3f}")
    texts, scores = jax_predict("fonts-hard", [
        arrays["hard_canvas"][i, :h, :w]
        for i, (h, w) in enumerate(
            zip(arrays["hard_heights"], arrays["hard_widths"]))
    ], "bfloat16", True)
    arrays["hard_texts_bf16"] = np.array(texts)
    arrays["hard_scores_bf16"] = scores
    diff = sum(a != b for a, b in zip(texts, arrays["hard_texts_f32"]))
    print(f"fonts-hard bf16 (Pallas interpret) vs f32: {diff} lines differ")
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez_compressed(OUT, **arrays)
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
