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

``--train`` writes ``crnn_ocr_torch/testdata/train_goldens.npz`` instead,
from the committed greedy goldens: one f32 ``fonts-hard`` train step of the
JAX package (``train/step.py``'s loss: dropout 0, the scan CTC and scan
recurrence, which its tests hold equal to the Pallas kernels) on the 64
``hard`` lines repeated to 128, bucket 256, labels padded to 32:

* ``loss_vec`` (128,), ``loss`` and ``grad_norm`` (the global norm before
  clipping);
* ``gradnorm/<name>``: each parameter's gradient norm, under the port's
  ``state_dict`` names;
* ``stats/<name>``: every BatchNorm's running statistics after the step.

Under the prefix ``small/`` the same keys hold one f32 ``fonts-small``
train step on the 64 ``small`` lines repeated to 128, bucket 128, labels
padded to 32, dropout 0. That is the shape at which the JAX package trains
through its fused train stem (``kernels/fused_stem_train.py``: the batch
statistics, the stem backward), and the golden takes that path, in Pallas
interpret mode (``use_fused_stem=True``, ``pallas_interpret=True``; the
recurrence and the CTC loss stay the scan versions). The ``--train`` run
takes under a minute on the CPU.

``--stn`` writes ``crnn_ocr_torch/testdata/stn_goldens.npz`` for the two
STN models, 64 lines each from its own task, width-filtered to 256:

* prefix ``warp_`` (``fonts-warp-stn``: the render-time warped task that
  ``benchmarks/stn_ab_eval.json`` records) and ``stn_`` (``fonts-stn``: the
  default ``FontConfig``, the task of ``tests/test_pretrained.py``), each
  with ``canvas``/``heights``/``widths``/``truth`` and the JAX f32
  ``texts_f32``/``scores_f32`` as above;
* ``warp_texts_bf16``/``warp_scores_bf16``: ``fonts-warp-stn`` as shipped
  (bf16), its sampler through ``bilinear_sample_pallas`` (K11) and the
  serve stem and recurrence through their Pallas kernels, all in interpret
  mode;
* ``train/...``: one f32 ``fonts-warp-stn`` train step as ``--train``
  writes it (dropout 0, the 64 ``warp`` lines repeated to 128, bucket 256,
  labels padded to 32; the sampler is the JAX package's XLA path under
  ``jax.grad``), STN leaves included.

``--lstm`` writes ``crnn_ocr_torch/testdata/lstm_goldens.npz`` for
``fonts-hard-lstm``: ``fonts-hard`` with its two BiGRU layers replaced by
the port's seeded BiLSTM layers (``crnn_ocr_torch/infer/weights.py::
seeded_rnn_params``, seed 0; ``infer/pretrained.py::VARIANTS``), on the 64
``hard`` lines of the committed greedy goldens:

* ``lstm_texts_f32``/``lstm_scores_f32``: the JAX predictor in f32 (the
  XLA stem and the ``lax.scan`` LSTM, which carries h and c in f32 as the
  Pallas kernel does);
* ``lstm_texts_bf16``/``lstm_scores_bf16``: in bf16 through the serve stem
  and ``bilstm_pallas_raw`` in interpret mode (``lax.scan`` would carry h
  and c in bf16, which the Pallas kernel and the port do not);
* ``lstm_probs_f32``/``lstm_probs_bf16``: the two runs' probabilities
  (8, 62, 63) on the first 8 lines. The seeded BiLSTM's outputs, normalized
  by ``fonts-hard``'s ``rnn_bn`` statistics (fit to its GRU's outputs),
  leave the trained logits layer on blank in every frame, so every text is
  empty: the probabilities are what holds the forward pass to JAX's;
* ``lstm_weights_sha256``: the digest of the seeded layers' bytes, so that
  a reader can tell that it rebuilt the weights the golden saw;
* ``train/...``: one f32 train step as ``--train`` writes it (dropout 0,
  the lines repeated to 128, bucket 256, labels padded to 32).

``--beam`` writes ``crnn_ocr_torch/testdata/beam_goldens.npz``: the JAX
package's beam search and alignment on the committed greedy goldens' lines
(64 each of ``hard`` and ``small``), under the prefix ``hard_`` or
``small_``:

* ``probs`` (64, T, C) and ``input_len`` (64,): the JAX f32 predictor's
  probabilities at ``bucket`` (the bucket the batch resolves to);
* ``beam_m1_decoded``/``beam_m1_scores`` and ``beam_m0_...``: the device
  beam (``ops/ctc_beam_device.py::ctc_beam_search_decode_tf``) on them, W
  ``BEAM_WIDTH``, ``TOP_PATHS`` paths, ``merge_repeated`` True (m1) and
  False (m0); decoded (TOP_PATHS, 64, T) int16;
* ``greedy_align_{labels,starts,ends,confs}``: ``ctc_greedy_alignment``;
* ``forced_{starts,ends,confs,feasible}``: ``ctc_forced_alignment`` of the
  m0 beam's top path (``merge_repeated=False``, the bundled models'
  default);

and, for ``fonts-hard`` only, its predictor's ``predict(greedy=False,
alignments=True)``: ``hard_pred_texts_f32``/``hard_pred_scores_f32`` and
its spans (``hard_pred_spans_f32`` (N, 3) int32: line, x0, x1, with
``hard_pred_span_chars_f32`` and ``hard_pred_span_confs_f32``) in f32, and
``hard_pred_texts_bf16``/``hard_pred_scores_bf16`` as shipped (bf16, both
Pallas serve kernels in interpret mode). About a minute.

``--serve`` writes ``crnn_ocr_torch/testdata/serve_goldens.npz``: the JAX
predictor's ``predict_many`` (each line at its own ``bucket_for`` bucket,
64 lines a chunk) over the committed greedy goldens' 64 ``hard`` lines,
as the serving batcher and the predict CLI route them:

* ``bucket`` (64,): each line's ``bucket_for``;
* ``greedy_texts_f32``/``greedy_scores_f32``: ``fonts-hard`` in f32;
* ``greedy_texts_bf16``/``greedy_scores_bf16``: as shipped (bf16, both
  Pallas serve kernels in interpret mode);
* ``beam_texts_f32``/``beam_scores_f32``: ``greedy=False``, W
  ``SERVE_BEAM_WIDTH``, one path, the bundled models' merge default;
* ``align_spans_f32`` (N, 3) int32 (line, x0, x1), ``align_chars_f32`` and
  ``align_confs_f32``: the f32 greedy ``alignments=True`` spans;
* ``cond_*``: the same f32 runs (greedy with alignments, and the beam) for
  each line alone under each canvas it can meet in a batch. The canvas is
  the batch's largest height and width snapped up ``quantize_dim``'s
  ladder, and a line's resize reads the canvas's first row and column past
  it (white) when there is one, so a line whose height or width lies on
  the ladder reads differently when it is the batch's tallest or widest.
  ``cond_line``, ``cond_pad_h``, ``cond_pad_w`` (K,) name each variant
  (``chip_smoke.canvas_variants``: padded on both axes always, unpadded on
  an axis where the line's size is on the ladder), run as the line and a
  white filler (``chip_smoke.padded_batch``) at the line's bucket;
  ``cond_{greedy,beam}_{texts,scores}_f32`` and ``cond_align_spans_f32``
  (N, 3: variant, x0, x1), ``cond_align_chars_f32``,
  ``cond_align_confs_f32``.

``--orbax`` writes the orbax fixture ``crnn_ocr_torch/testdata/
orbax_small/`` (a model directory of the JAX package's
``CheckpointManager``: ``model_config.json``, ``classes.json`` and step 2,
an orbax checkpoint of the whole train state) and ``crnn_ocr_torch/
testdata/orbax_goldens.npz``. The model is ``ORBAX_CFG`` (f32, dropout 0:
a 64-filter stem and one BiGRU of 128 units, which the port's kernels
take, the rest narrow; its recurrent kernel, 384 KiB, is the largest
leaf, so its zstd frame spans blocks), seeded by ``jax.random.key(0)``,
with Adam at ``ORBAX_LR``, and its batch the first ``ORBAX_BATCH``
``small`` lines of the committed greedy goldens at bucket 128, labels
padded to 32. Three steps of JAX's ``make_train_step`` (the XLA stem, the
scan recurrence and the scan CTC) run on that batch; the state after the
second is the checkpoint, and the goldens hold the third:

* ``canvas``/``heights``/``widths``/``truth``/``bucket``: the batch;
* ``loss``, ``loss_vec``, ``grad_norm``: the third step's;
* ``after/<name>``: every entry of the port's ``state_dict`` after it;
* ``noise/<name>``: ``np.packbits`` of the parameter's elements whose
  third-step gradient is at most 1e-5 of its tensor's largest (the
  elements whose Adam update f32 noise can turn, see
  ``tests/test_torch_train.py``), ``noise_shape/<name>`` its shape;
* ``lr``, ``step`` (2, the checkpoint's step).

``--surface`` writes ``crnn_ocr_torch/testdata/surface_goldens.npz`` for
``chip_smoke.py`` phase 31, from the inputs that
``chip_smoke.surface_inputs`` makes from its seed (numpy ``RandomState``,
so the card rebuilds them without JAX), through the JAX package's
``ops`` on the CPU:

* ``ctc_b0/loss``, ``ctc_b62/loss`` (B,): ``ctc_forward_log_loss`` at
  blank 0 and at blank C - 1 (62); ``ctc_b0/grad``: the gradient of the
  blank-0 losses' sum for the first ``SURFACE_GOLDEN_CTC_ROWS`` samples;
* ``up/`` and ``down/``: ``grid_sample_affine`` of the one-channel images
  to 32x256 and 16x64 (its banded sampler on the CPU): ``out`` and
  ``d_img`` of the first image, ``d_theta`` (B, 6) of every image, for
  the loss ``sum(out * g)``;
* ``c3/``: ``bilinear_sample`` of the 3-channel images at their own size:
  ``out``, ``d_img`` and ``d_coords`` of the first image.

Run from the repo root (several minutes on the CPU):

    JAX_PLATFORMS=cpu python tools/gen_torch_goldens.py \
        [--train | --stn | --lstm | --beam | --serve | --orbax | --surface]
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
OUT = os.path.join(REPO, "crnn_ocr_torch", "testdata", "greedy_goldens.npz")
TRAIN_OUT = os.path.join(REPO, "crnn_ocr_torch", "testdata",
                         "train_goldens.npz")
STN_OUT = os.path.join(REPO, "crnn_ocr_torch", "testdata", "stn_goldens.npz")
LSTM_OUT = os.path.join(REPO, "crnn_ocr_torch", "testdata",
                        "lstm_goldens.npz")
BEAM_OUT = os.path.join(REPO, "crnn_ocr_torch", "testdata",
                        "beam_goldens.npz")
SERVE_OUT = os.path.join(REPO, "crnn_ocr_torch", "testdata",
                         "serve_goldens.npz")
ORBAX_DIR = os.path.join(REPO, "crnn_ocr_torch", "testdata", "orbax_small")
ORBAX_OUT = os.path.join(REPO, "crnn_ocr_torch", "testdata",
                         "orbax_goldens.npz")
ORBAX_CFG = dict(width=128, stem_filters=64, block_filters=(16, 16, 24, 24),
                 time_dense_size=32, n_units=128, rnn_layers=1,
                 rnn_cell="gru", dropout_rate=0.0, dtype="float32")
ORBAX_BATCH, ORBAX_LR = 32, 1e-4
BEAM_WIDTH, TOP_PATHS = 10, 3
SERVE_BEAM_WIDTH = 10
LSTM_NAME = "fonts-hard-lstm"
LSTM_PROBS = 8  # lines whose probabilities lstm_goldens.npz keeps
TRAIN_BATCH, TRAIN_BUCKET, TRAIN_MAX_LABEL = 128, 256, 32

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
STN_TASKS = {
    "warp": dict(
        model="fonts-warp-stn", bucket=256, seed=20263,
        font=dict(min_words=1, max_words=2, noise=0.06, min_size=16,
                  max_size=24, warp_shear=0.9, warp_rotate=4.0,
                  warp_perspective=0.25),
    ),
    "stn": dict(model="fonts-stn", bucket=256, seed=20264, font=dict()),
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


def jax_model(name: str):
    """The JAX package's ``(cfg, params, batch_stats, codec)`` of a bundled
    model, or of one of the port's variants (the bundled model with the
    port's seeded BiLSTM layers, ``infer/pretrained.py::VARIANTS``)."""
    from crnn_ocr_torch.infer.pretrained import VARIANTS
    from crnn_ocr_torch.infer.weights import seeded_rnn_params
    from crnn_ocr_tpu.infer import load_pretrained

    base, seed = VARIANTS.get(name, (name, None))
    p = load_pretrained(base)
    cfg, params = p.cfg, p._vars["params"]
    if seed is not None:
        cfg = dataclasses.replace(cfg, rnn_cell="lstm")
        params = {**params, **seeded_rnn_params(cfg, seed)}
    return cfg, params, p._vars["batch_stats"], p.codec


def jax_predictor(name: str, dtype: str, pallas: bool):
    """The JAX predictor of ``name`` in ``dtype``, on the XLA paths or with
    every Pallas kernel in interpret mode, and the context to predict in
    (it routes an STN's sampler to its kernel)."""
    import contextlib

    from crnn_ocr_tpu.infer.predictor import Predictor
    from crnn_ocr_tpu.models import CRNN
    from crnn_ocr_tpu.models import stn as stn_mod

    cfg, params, stats, codec = jax_model(name)
    cfg = dataclasses.replace(
        cfg, dtype=dtype, use_pallas_rnn=pallas, use_fused_stem=pallas
    )
    pred = Predictor(cfg, params, stats, codec)
    route = contextlib.nullcontext()
    if pallas:
        # the forward closure reads pred._model when it traces
        pred._model = CRNN(cfg=cfg, pallas_interpret=True)
        if cfg.use_stn:  # the sampler too, as tests/test_kernels.py routes it
            route = _pallas_sampler(stn_mod)
    return pred, route


def jax_predict(name: str, images, dtype: str, pallas: bool):
    pred, route = jax_predictor(name, dtype, pallas)
    with route:
        out = pred.predict(images)
    return [p.text for p in out], np.array([p.score for p in out], np.float32)


def _pallas_sampler(stn_mod):
    import contextlib

    @contextlib.contextmanager
    def ctx():
        orig = stn_mod.grid_sample_affine
        stn_mod.grid_sample_affine = (
            lambda img, theta, mesh=None, interpret=False, **kw: orig(
                img, theta, use_pallas=True, interpret=True))
        try:
            yield
        finally:
            stn_mod.grid_sample_affine = orig

    return ctx()


def train_batch(g, codec, key="hard"):
    """The train golden's batch from the committed goldens: canvas,
    heights, widths (numpy, the 64 ``key`` lines repeated to 128), dense
    labels and label lengths."""
    reps = TRAIN_BATCH // len(g[f"{key}_heights"])
    canvas = np.concatenate([g[f"{key}_canvas"]] * reps)
    hs = np.concatenate([g[f"{key}_heights"]] * reps)
    ws = np.concatenate([g[f"{key}_widths"]] * reps)
    truth = [str(t) for t in g[f"{key}_truth"]] * reps
    labels, lab_len = codec.encode_batch(truth, TRAIN_MAX_LABEL)
    return canvas, hs, ws, labels, lab_len


def train_step_golden(model_name: str, g, key: str,
                      bucket: int = TRAIN_BUCKET,
                      fused_stem: bool = False) -> dict:
    """One f32 train step of ``model_name`` (dropout 0; XLA paths, or the
    fused train stem in interpret mode with ``fused_stem``) on the ``key``
    lines of ``g`` at ``bucket``: loss_vec, loss, grad_norm,
    gradnorm/<name>, stats/<name>."""
    import jax
    import jax.numpy as jnp

    from crnn_ocr_torch.infer.weights import params_from_jax
    from crnn_ocr_tpu.models import CRNN
    from crnn_ocr_tpu.ops.preprocess import preprocess_batch
    from crnn_ocr_tpu.train.step import ctc_loss_vec, optax_global_norm

    cfg, params, stats, codec = jax_model(model_name)
    cfg = dataclasses.replace(cfg, dtype="float32", dropout_rate=0.0,
                              use_pallas_rnn=False, use_fused_stem=fused_stem)
    model = CRNN(cfg=cfg, pallas_interpret=fused_stem)
    canvas, hs, ws, labels, lab_len = train_batch(g, codec, key)
    x, w_new = preprocess_batch(canvas, hs, ws, out_h=cfg.height,
                                out_w=bucket)
    T = bucket // cfg.width_downsample
    il = jnp.maximum(jnp.minimum(w_new // cfg.width_downsample, T)
                     - cfg.ctc_time_slice, 1).astype(jnp.int32)

    def loss_fn(p):
        logits, mutated = model.apply(
            {"params": p, "batch_stats": stats}, x[..., None], train=True,
            mutable=["batch_stats"], rngs={"dropout": jax.random.key(0)})
        loss_vec = ctc_loss_vec(logits, jnp.asarray(labels), il,
                                jnp.asarray(lab_len),
                                ctc_time_slice=cfg.ctc_time_slice)
        loss = jnp.mean(jnp.minimum(loss_vec, 1e4))
        return loss, (loss_vec, mutated["batch_stats"])

    (loss, (loss_vec, new_stats)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    grad_sd = params_from_jax(to_np(grads), to_np(new_stats))
    stat_sd = params_from_jax(to_np(params), to_np(new_stats))
    arrays = {"loss_vec": np.asarray(loss_vec), "loss": np.float32(loss),
              "grad_norm": np.float32(optax_global_norm(grads))}
    for k, v in grad_sd.items():
        if k.endswith(("running_mean", "running_var")):
            arrays[f"stats/{k}"] = stat_sd[k].numpy()
        else:
            arrays[f"gradnorm/{k}"] = np.float32(np.linalg.norm(v.numpy()))
    print(f"{model_name} train golden: loss {float(loss):.6f} grad_norm "
          f"{float(arrays['grad_norm']):.6f}")
    return arrays


def write_train_golden() -> None:
    g = np.load(OUT)
    arrays = train_step_golden("fonts-hard", g, "hard")
    for k, v in train_step_golden("fonts-small", g, "small", bucket=128,
                                  fused_stem=True).items():
        arrays[f"small/{k}"] = v
    np.savez_compressed(TRAIN_OUT, **arrays)
    print(f"wrote {TRAIN_OUT} ({os.path.getsize(TRAIN_OUT)} bytes)")


def golden_lines(arrays: dict, tasks: dict) -> dict:
    """Render each task's lines and run the JAX predictor in f32 on them."""
    from crnn_ocr_tpu.ops.preprocess import pack_canvas

    for key, task in tasks.items():
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
    return arrays


def bf16_golden(arrays: dict, key: str, model: str) -> None:
    texts, scores = jax_predict(model, [
        arrays[f"{key}_canvas"][i, :h, :w]
        for i, (h, w) in enumerate(
            zip(arrays[f"{key}_heights"], arrays[f"{key}_widths"]))
    ], "bfloat16", True)
    arrays[f"{key}_texts_bf16"] = np.array(texts)
    arrays[f"{key}_scores_bf16"] = scores
    diff = sum(a != b for a, b in zip(texts, arrays[f"{key}_texts_f32"]))
    print(f"{model} bf16 (Pallas interpret) vs f32: {diff} lines differ")


def write_stn_goldens() -> None:
    arrays = golden_lines({}, STN_TASKS)
    bf16_golden(arrays, "warp", "fonts-warp-stn")
    for k, v in train_step_golden("fonts-warp-stn", arrays, "warp").items():
        arrays[f"train/{k}"] = v
    np.savez_compressed(STN_OUT, **arrays)
    print(f"wrote {STN_OUT} ({os.path.getsize(STN_OUT)} bytes)")


def write_lstm_goldens() -> None:
    g = np.load(OUT)
    images = [g["hard_canvas"][i, :h, :w] for i, (h, w) in
              enumerate(zip(g["hard_heights"], g["hard_widths"]))]
    arrays = {}
    for dtype, pallas in (("float32", False), ("bfloat16", True)):
        pred, _ = jax_predictor(LSTM_NAME, dtype, pallas)
        out = pred.predict(images, bucket=TRAIN_BUCKET)
        tag = "f32" if dtype == "float32" else "bf16"
        arrays[f"lstm_texts_{tag}"] = np.array([p.text for p in out])
        arrays[f"lstm_scores_{tag}"] = np.array([p.score for p in out],
                                                np.float32)
        probs, in_len = pred.predict_probs(images, bucket=TRAIN_BUCKET)
        probs = np.asarray(probs, np.float32)
        arrays[f"lstm_probs_{tag}"] = probs[:LSTM_PROBS]
        # each frame's top class over its runner-up, in log-probability:
        # how far a rounding difference must move the logits to flip a text
        top2 = np.log(np.sort(probs, axis=-1)[..., -2:])
        live = np.arange(probs.shape[1])[None] < np.asarray(in_len)[:, None]
        margin = (top2[..., 1] - top2[..., 0])[live]
        blank = probs.argmax(-1)[live] == probs.shape[-1] - 1
        print(f"{LSTM_NAME} {dtype}: {sum(map(bool, arrays[f'lstm_texts_{tag}']))}"
              f" non-empty texts of {len(out)}, blank on {blank.mean():.4f} of "
              f"the frames; smallest top-1 over top-2 margin {margin.min():.4f}"
              " (log-probability)")
    diff = sum(a != b for a, b in zip(arrays["lstm_texts_bf16"],
                                      arrays["lstm_texts_f32"]))
    print(f"{LSTM_NAME} bf16 (Pallas interpret) vs f32: {diff} lines differ")
    from crnn_ocr_torch.infer.weights import rnn_params_digest

    arrays["lstm_weights_sha256"] = np.array(
        rnn_params_digest(jax_model(LSTM_NAME)[1]))
    for k, v in train_step_golden(LSTM_NAME, g, "hard").items():
        arrays[f"train/{k}"] = v
    np.savez_compressed(LSTM_OUT, **arrays)
    print(f"wrote {LSTM_OUT} ({os.path.getsize(LSTM_OUT)} bytes)")


def write_beam_goldens() -> None:
    import jax.numpy as jnp

    from crnn_ocr_tpu.ops import ctc
    from crnn_ocr_tpu.ops.ctc_beam_device import ctc_beam_search_decode_tf

    g = np.load(OUT)
    arrays = {}
    for key, task in TASKS.items():
        images = [g[f"{key}_canvas"][i, :h, :w] for i, (h, w) in
                  enumerate(zip(g[f"{key}_heights"], g[f"{key}_widths"]))]
        pred, _ = jax_predictor(task["model"], "float32", False)
        bucket = pred.resolve_bucket(images)
        probs, in_len = pred.predict_probs(images, bucket=bucket)
        arrays[f"{key}_probs"] = np.asarray(probs, np.float32)
        arrays[f"{key}_input_len"] = np.asarray(in_len, np.int32)
        arrays[f"{key}_bucket"] = np.array(bucket)
        for merge in (1, 0):
            dec, sc = ctc_beam_search_decode_tf(
                probs, in_len, beam_width=BEAM_WIDTH, top_paths=TOP_PATHS,
                merge_repeated=bool(merge))
            arrays[f"{key}_beam_m{merge}_decoded"] = np.asarray(dec, np.int16)
            arrays[f"{key}_beam_m{merge}_scores"] = np.asarray(sc)
        for name, v in zip(("labels", "starts", "ends", "confs"),
                           ctc.ctc_greedy_alignment(probs, in_len)):
            arrays[f"{key}_greedy_align_{name}"] = np.asarray(v)
        top = jnp.asarray(arrays[f"{key}_beam_m0_decoded"][0], jnp.int32)
        for name, v in zip(("starts", "ends", "confs", "feasible"),
                           ctc.ctc_forced_alignment(
                               probs, in_len, jnp.maximum(top, 0),
                               jnp.sum(top >= 0, axis=1))):
            arrays[f"{key}_forced_{name}"] = np.asarray(v)
        if key != "hard":
            continue
        for dtype, pallas, tag in (("float32", False, "f32"),
                                   ("bfloat16", True, "bf16")):
            pred, _ = jax_predictor(task["model"], dtype, pallas)
            out = pred.predict(images, greedy=False, alignments=True)
            arrays[f"hard_pred_texts_{tag}"] = np.array([p.text for p in out])
            arrays[f"hard_pred_scores_{tag}"] = np.array(
                [p.score for p in out], np.float32)
            if tag == "f32":
                spans = [(i, s) for i, p in enumerate(out) for s in p.spans]
                arrays["hard_pred_spans_f32"] = np.array(
                    [(i, s.x0, s.x1) for i, s in spans], np.int32)
                arrays["hard_pred_span_chars_f32"] = np.array(
                    [s.char for _, s in spans])
                arrays["hard_pred_span_confs_f32"] = np.array(
                    [s.conf for _, s in spans], np.float32)
        diff = sum(a != b for a, b in zip(arrays["hard_pred_texts_bf16"],
                                          arrays["hard_pred_texts_f32"]))
        print(f"fonts-hard beam bf16 (Pallas interpret) vs f32: {diff} "
              "lines differ")
    np.savez_compressed(BEAM_OUT, **arrays)
    print(f"wrote {BEAM_OUT} ({os.path.getsize(BEAM_OUT)} bytes)")


def write_serve_goldens() -> None:
    g = np.load(OUT)
    images = [g["hard_canvas"][i, :h, :w] for i, (h, w) in
              enumerate(zip(g["hard_heights"], g["hard_widths"]))]
    pred, _ = jax_predictor("fonts-hard", "float32", False)
    arrays = {"bucket": np.array([pred.bucket_for(im) for im in images],
                                 np.int32)}
    runs = (("greedy", "f32", pred, {}),
            ("greedy", "bf16", jax_predictor("fonts-hard", "bfloat16",
                                             True)[0], {}),
            ("beam", "f32", pred, dict(greedy=False,
                                       beam_width=SERVE_BEAM_WIDTH)))
    for mode, tag, p, kw in runs:
        out = p.predict_many(images, batch_size=N_LINES, **kw)
        arrays[f"{mode}_texts_{tag}"] = np.array([o.text for o in out])
        arrays[f"{mode}_scores_{tag}"] = np.array([o.score for o in out],
                                                  np.float32)
    out = pred.predict_many(images, batch_size=N_LINES, alignments=True)
    spans = [(i, s) for i, o in enumerate(out) for s in o.spans]
    arrays["align_spans_f32"] = np.array([(i, s.x0, s.x1) for i, s in spans],
                                         np.int32)
    arrays["align_chars_f32"] = np.array([s.char for _, s in spans])
    arrays["align_confs_f32"] = np.array([s.conf for _, s in spans],
                                         np.float32)
    from chip_smoke import canvas_variants, padded_batch

    cond = {k: [] for k in ("line", "pad_h", "pad_w", "greedy_texts",
                            "greedy_scores", "beam_texts", "beam_scores")}
    cspans = []
    for i, im in enumerate(images):
        bucket = int(arrays["bucket"][i])
        for pad_h, pad_w in canvas_variants(im):
            batch = padded_batch(im, pad_h, pad_w)
            greedy = pred.predict(batch, bucket=bucket, alignments=True)[0]
            beam = pred.predict(batch, bucket=bucket, greedy=False,
                                beam_width=SERVE_BEAM_WIDTH)[0]
            k = len(cond["line"])
            cspans += [(k, s) for s in greedy.spans]
            for key, v in (("line", i), ("pad_h", pad_h), ("pad_w", pad_w),
                           ("greedy_texts", greedy.text),
                           ("greedy_scores", greedy.score),
                           ("beam_texts", beam.text),
                           ("beam_scores", beam.score)):
                cond[key].append(v)
    for key in ("line", "pad_h", "pad_w"):
        arrays[f"cond_{key}"] = np.array(cond[key])
    for key in ("greedy_texts", "beam_texts"):
        arrays[f"cond_{key}_f32"] = np.array(cond[key])
    for key in ("greedy_scores", "beam_scores"):
        arrays[f"cond_{key}_f32"] = np.array(cond[key], np.float32)
    arrays["cond_align_spans_f32"] = np.array(
        [(k, s.x0, s.x1) for k, s in cspans], np.int32)
    arrays["cond_align_chars_f32"] = np.array([s.char for _, s in cspans])
    arrays["cond_align_confs_f32"] = np.array([s.conf for _, s in cspans],
                                              np.float32)
    moved = sum(len({t for li, t in zip(cond["line"], cond["greedy_texts"])
                     if li == i}) > 1 for i in range(len(images)))
    print(f"{len(cond['line'])} canvas variants of {len(images)} lines; "
          f"{moved} lines read differently under another canvas")
    one = [p.text for p in pred.predict(images)]
    for key in ("greedy_texts_bf16", "beam_texts_f32"):
        diff = sum(a != b for a, b in zip(arrays[key],
                                          arrays["greedy_texts_f32"]))
        print(f"{key} vs greedy f32: {diff} lines differ")
    diff = sum(a != b for a, b in zip(one, arrays["greedy_texts_f32"]))
    print(f"per-line buckets {np.bincount(arrays['bucket'])[64::64]} vs one "
          f"bucket for all: {diff} greedy f32 lines differ")
    np.savez_compressed(SERVE_OUT, **arrays)
    print(f"wrote {SERVE_OUT} ({os.path.getsize(SERVE_OUT)} bytes)")


def write_orbax_goldens() -> None:
    import shutil

    import jax
    import jax.numpy as jnp

    from crnn_ocr_torch.infer.weights import params_from_jax
    from crnn_ocr_tpu.data.codec import LabelCodec
    from crnn_ocr_tpu.infer.pretrained import pretrained_dir
    from crnn_ocr_tpu.models import CRNN, ModelConfig
    from crnn_ocr_tpu.ops.preprocess import preprocess_batch
    from crnn_ocr_tpu.train.checkpoint import CheckpointManager
    from crnn_ocr_tpu.train.state import create_train_state
    from crnn_ocr_tpu.train.step import ctc_loss_vec, make_train_step

    g = np.load(OUT)
    codec = LabelCodec.load(os.path.join(pretrained_dir("fonts-small"),
                                         "classes.json"))
    cfg = ModelConfig(num_classes=codec.num_classes, use_pallas_rnn=False,
                      use_fused_stem=False, **ORBAX_CFG)
    n, bucket = ORBAX_BATCH, 128
    canvas = g["small_canvas"][:n]
    hs, ws = g["small_heights"][:n], g["small_widths"][:n]
    truth = [str(t) for t in g["small_truth"][:n]]
    labels, lab_len = codec.encode_batch(truth, TRAIN_MAX_LABEL)
    x, w_new = preprocess_batch(canvas, hs, ws, out_h=cfg.height,
                                out_w=bucket)
    T = bucket // cfg.width_downsample
    il = jnp.maximum(jnp.minimum(w_new // cfg.width_downsample, T)
                     - cfg.ctc_time_slice, 1).astype(jnp.int32)
    batch = {"x": x, "input_length": il, "the_labels": jnp.asarray(labels),
             "label_length": jnp.asarray(lab_len)}
    state = create_train_state(cfg, jax.random.key(0),
                               learning_rate=ORBAX_LR)
    step = make_train_step(cfg, donate=False, use_pallas_ctc=False)
    rng = jax.random.key(0)
    for _ in range(2):
        state, _ = step(state, batch, rng)
    shutil.rmtree(ORBAX_DIR, ignore_errors=True)
    mgr = CheckpointManager(ORBAX_DIR)
    mgr.save(int(state.step), state, model_cfg=cfg, codec=codec)
    mgr.wait()

    def loss_fn(p):
        logits, _ = CRNN(cfg=cfg).apply(
            {"params": p, "batch_stats": state.batch_stats},
            x[..., None], train=True, mutable=["batch_stats"],
            rngs={"dropout": rng})
        vec = ctc_loss_vec(logits, batch["the_labels"], il,
                           batch["label_length"], cfg.ctc_time_slice)
        vec = jnp.minimum(vec, 1e4)
        return jnp.mean(vec), vec

    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    grads, loss_vec = jax.jit(jax.grad(loss_fn, has_aux=True))(state.params)
    after, m = step(state, batch, rng)
    arrays = {"canvas": canvas, "heights": hs, "widths": ws,
              "truth": np.array(truth), "bucket": np.int32(bucket),
              "loss": np.float32(m["loss"]),
              "grad_norm": np.float32(m["grad_norm"]),
              "loss_vec": np.asarray(loss_vec), "lr": np.float32(ORBAX_LR),
              "step": np.int32(state.step)}
    for k, v in params_from_jax(to_np(after.params),
                                to_np(after.batch_stats)).items():
        arrays[f"after/{k}"] = v.numpy()
    for k, v in params_from_jax(to_np(grads), to_np(after.batch_stats)
                                ).items():
        if k.endswith(("running_mean", "running_var")):
            continue
        v = np.abs(v.numpy())
        arrays[f"noise/{k}"] = np.packbits(v <= 1e-5 * v.max())
        arrays[f"noise_shape/{k}"] = np.array(v.shape, np.int32)
    np.savez_compressed(ORBAX_OUT, **arrays)
    size = sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(ORBAX_DIR) for f in fs)
    print(f"orbax fixture: {size} bytes in {ORBAX_DIR}; third step loss "
          f"{float(m['loss']):.6f}; wrote {ORBAX_OUT} "
          f"({os.path.getsize(ORBAX_OUT)} bytes)")


SURFACE_OUT = os.path.join(REPO, "crnn_ocr_torch", "testdata",
                           "surface_goldens.npz")


def write_surface_goldens() -> None:
    import jax
    import jax.numpy as jnp

    from chip_smoke import (
        SURFACE_CTC,
        SURFACE_GOLDEN_CTC_ROWS,
        SURFACE_SIZES,
        labels_for_blank,
        surface_inputs,
    )
    from crnn_ocr_tpu.ops import ctc as jctc
    from crnn_ocr_tpu.ops import grid_sample as jgs

    t = surface_inputs()
    C = SURFACE_CTC[2]
    arrays = {}
    for blank in (0, C - 1):
        lab = labels_for_blank(t["labels"], blank)

        def total(x, lab=lab, blank=blank):
            loss = jctc.ctc_forward_log_loss(x, lab, t["il"], t["ll"], blank)
            return jnp.sum(loss), loss

        (_, loss), grad = jax.jit(jax.value_and_grad(total, has_aux=True))(
            jnp.asarray(t["lp"]))
        arrays[f"ctc_b{blank}/loss"] = np.asarray(loss)
        if blank == 0:
            arrays["ctc_b0/grad"] = np.asarray(grad)[:SURFACE_GOLDEN_CTC_ROWS]
    chunk = 32  # images a call: the banded sampler's weights grow with B
    for name, (Ho, Wo, c) in SURFACE_SIZES.items():
        g = t[f"g_{name}"]
        if c == 1:
            # op by op, as the port computes the grid: under jit XLA fuses
            # the affine's products into its sums, which moves coordinates
            # by an ulp and flips floor() at some samples
            def warp(img, th, Ho=Ho, Wo=Wo):
                return jgs.grid_sample_affine(img, th, Ho, Wo)

            d_theta = []
            for i in range(0, len(g), chunk):
                img = jnp.asarray(t["img"][i:i + chunk, ..., None])
                out, vjp = jax.vjp(warp, img, jnp.asarray(
                    t["theta"][i:i + chunk]))
                d_img, d_th = vjp(jnp.asarray(g[i:i + chunk]))
                if i == 0:
                    arrays[f"{name}/out"] = np.asarray(out)[:1]
                    arrays[f"{name}/d_img"] = np.asarray(d_img)[:1]
                d_theta.append(np.asarray(d_th))
            arrays[f"{name}/d_theta"] = np.concatenate(d_theta)
        else:
            coords = jgs.affine_grid(jnp.asarray(t["theta"][:1]), Ho, Wo)
            out, vjp = jax.vjp(jax.jit(jgs.bilinear_sample),
                               jnp.asarray(t["img3"][:1]), coords)
            d_img, d_coords = vjp(jnp.asarray(g[:1]))
            arrays.update({f"{name}/out": np.asarray(out),
                           f"{name}/d_img": np.asarray(d_img),
                           f"{name}/d_coords": np.asarray(d_coords)})
    np.savez_compressed(SURFACE_OUT, **arrays)
    print(f"wrote {SURFACE_OUT} ({os.path.getsize(SURFACE_OUT)} bytes)")


def main() -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    if "--train" in sys.argv[1:]:
        write_train_golden()
        return 0
    if "--stn" in sys.argv[1:]:
        write_stn_goldens()
        return 0
    if "--lstm" in sys.argv[1:]:
        write_lstm_goldens()
        return 0
    if "--beam" in sys.argv[1:]:
        write_beam_goldens()
        return 0
    if "--serve" in sys.argv[1:]:
        write_serve_goldens()
        return 0
    if "--orbax" in sys.argv[1:]:
        write_orbax_goldens()
        return 0
    if "--surface" in sys.argv[1:]:
        write_surface_goldens()
        return 0
    arrays = golden_lines({}, TASKS)
    bf16_golden(arrays, "hard", "fonts-hard")
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez_compressed(OUT, **arrays)
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
