"""The fit loop and evaluation (``crnn_ocr_tpu/train/loop.py:29-459``),
single device, one train step per batch.

``fit`` runs the train step over a stream of device batches (from
``data.pipeline.device_batches``), logs every ``log_every`` steps (loss,
an EMA of it, the gradient norm, lines/s, the host's p50/p90/mean ms of
the step call) to stderr, to an optional JSONL file and to TensorBoard
where ``tensorboardX`` imports, evaluates every ``eval_every`` steps with
the greedy decoder (loss, CER, WER, sequence accuracy), checkpoints at
each evaluation (the best CER tracked) and once at the end, and stops
early after ``early_stop_patience`` evaluations without a better CER.
``profile_dir`` traces steps ``profile_at`` to ``profile_at +
profile_steps`` with ``torch.profiler``. Reading a logged loss syncs with
the device, so the loop syncs at log points only.

Dropout: each step's generator is seeded from ``(cfg.seed, state.step)``
alone (``step.step_seed``), as the JAX step folds the step into its key
(``crnn_ocr_tpu/train/step.py:199``); so a run resumed from a checkpoint
draws the masks a straight run draws.

Options of the JAX loop that belong to later slices raise
``NotImplementedError`` naming their ROADMAP item; none is ignored.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import sys
import time
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from crnn_ocr_torch.config import ModelConfig
from crnn_ocr_torch.data.codec import LabelCodec
from crnn_ocr_torch.ops import ctc
from crnn_ocr_torch.train import step as step_lib
from crnn_ocr_torch.train.checkpoint import CheckpointManager
from crnn_ocr_torch.train.state import TrainState
from crnn_ocr_torch.utils import metrics as metrics_lib
from crnn_ocr_torch.utils.profiling import StepTimer, xplane_trace


@dataclasses.dataclass
class FitConfig:
    steps: int = 1000  # total step budget, counted from state.step
    eval_every: int = 200
    eval_batches: int = 8
    early_stop_patience: int = 0  # 0 = off; evaluations without a better CER
    log_every: int = 50
    metrics_path: Optional[str] = None  # JSONL stream
    seed: int = 0  # the dropout stream's seed
    exact_keras_loss: bool = False
    checkpoint_dir: Optional[str] = None
    tensorboard_dir: Optional[str] = None  # needs tensorboardX, else off
    profile_dir: Optional[str] = None  # a torch.profiler Chrome trace
    profile_at: int = 5  # the trace starts this many batches in
    profile_steps: int = 20  # and ends this many batches later
    # Not ported yet: each raises NotImplementedError when set.
    steps_per_call: int = 1  # ROADMAP item 9 (K steps per dispatch)
    device_corpus: object = None  # ROADMAP item 9
    on_device_cer: bool = False  # ROADMAP item 12
    mesh: object = None  # ROADMAP item 13


_NOT_PORTED = (
    ("device_corpus", 9, "the device-resident corpus"),
    ("on_device_cer", 12, "on-device CER"),
    ("mesh", 13, "data parallelism"),
)


def _check_ported(cfg: FitConfig) -> None:
    for field, item, what in _NOT_PORTED:
        if getattr(cfg, field):
            raise NotImplementedError(
                f"FitConfig.{field}: {what} is not ported yet "
                f"(ROADMAP item {item})")
    if cfg.steps_per_call != 1:
        raise NotImplementedError(
            "FitConfig.steps_per_call > 1: the K-step dispatch is not "
            "ported yet (ROADMAP item 9)")


def _summary_writer(logdir: Optional[str]):
    """tensorboardX's ``SummaryWriter`` on ``logdir``, or None where it
    does not import (as the JAX loop behaves)."""
    if not logdir:
        return None
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        return None
    return SummaryWriter(logdir)


def fit(
    state: TrainState,
    model_cfg: ModelConfig,
    train_iter: Iterator[Dict],
    eval_iter_fn: Optional[Callable[[], Iterator[Dict]]] = None,
    codec: Optional[LabelCodec] = None,
    cfg: FitConfig = FitConfig(),
) -> TrainState:
    """Train ``state`` in place until ``cfg.steps`` steps in all (or early
    stopping, or the end of ``train_iter``); returns it."""
    _check_ported(cfg)
    train_step = step_lib.make_train_step(model_cfg, cfg.exact_keras_loss)
    eval_step = step_lib.make_eval_step(model_cfg)
    generator = torch.Generator(device=state.device)
    ckpt = (CheckpointManager(cfg.checkpoint_dir, track_metric="cer")
            if cfg.checkpoint_dir else None)
    timer = StepTimer(window=cfg.log_every)
    best_cer = float("inf")
    evals_since_improve = 0
    ema_loss = None
    lines_seen = 0
    t_start = time.time()
    mfile = open(cfg.metrics_path, "a") if cfg.metrics_path else None
    tb = _summary_writer(cfg.tensorboard_dir)
    trace = contextlib.ExitStack()  # holds the profiler window while open

    def log(rec: dict) -> None:
        if mfile:
            mfile.write(json.dumps(rec) + "\n")
            mfile.flush()
        if tb is not None:
            for k, v in rec.items():
                if isinstance(v, (int, float)) and k != "step":
                    tb.add_scalar(f"{rec['kind']}/{k}", v, rec["step"])

    try:
        for i, batch in enumerate(train_iter):
            if state.step >= cfg.steps:
                break
            if cfg.profile_dir and i == cfg.profile_at:
                trace.enter_context(xplane_trace(cfg.profile_dir))
            batch = {k: v for k, v in batch.items()
                     if k not in ("texts", "bucket")}
            generator.manual_seed(step_lib.step_seed(cfg.seed, state.step))
            with timer:
                m = train_step(state, batch, generator)
            if cfg.profile_dir and i == cfg.profile_at + cfg.profile_steps:
                trace.close()
                print(f"profile trace written to {cfg.profile_dir}",
                      file=sys.stderr)
            lines_seen += int(batch["x"].shape[0])
            gstep = state.step
            if gstep % cfg.log_every == 0 or i == 0:
                loss = float(m["loss"])
                ema_loss = (loss if ema_loss is None
                            else 0.9 * ema_loss + 0.1 * loss)
                wall = time.time() - t_start
                rec = {"kind": "train", "step": gstep, "loss": loss,
                       "ema_loss": ema_loss,
                       "grad_norm": float(m["grad_norm"]),
                       "lines_per_sec": lines_seen / wall, "wall": wall,
                       **{f"host_step_{k}": v
                          for k, v in timer.stats().items()}}
                print(f"step {gstep:6d} loss {loss:9.4f} ema {ema_loss:9.4f} "
                      f"gnorm {rec['grad_norm']:8.3f} "
                      f"{rec['lines_per_sec']:8.1f} lines/s", file=sys.stderr)
                log(rec)
            if eval_iter_fn and gstep % cfg.eval_every == 0:
                ev = evaluate(state, eval_step, eval_iter_fn(), codec,
                              cfg.eval_batches)
                ev["step"] = gstep
                print(f"eval  step {gstep}: loss {ev['loss']:.4f} "
                      f"CER {ev['cer']:.4f} WER {ev['wer']:.4f} "
                      f"acc {ev['seq_acc']:.4f}", file=sys.stderr)
                log({"kind": "eval", **ev})
                if ckpt:
                    ckpt.save(gstep, state, model_cfg, codec, metrics=ev)
                if ev["cer"] < best_cer - 1e-6:
                    best_cer = ev["cer"]
                    evals_since_improve = 0
                else:
                    evals_since_improve += 1
                    if (cfg.early_stop_patience and evals_since_improve
                            >= cfg.early_stop_patience):
                        print("early stopping", file=sys.stderr)
                        break
        trace.close()  # where the loop ended inside the window
        if ckpt:
            ckpt.save(state.step, state, model_cfg, codec)
            ckpt.wait()
    finally:
        trace.close()
        if mfile:
            mfile.close()
        if tb is not None:
            tb.close()
    return state


def evaluate(
    state: TrainState,
    eval_step,
    eval_iter: Iterator[Dict],
    codec: Optional[LabelCodec],
    max_batches: int = 8,
) -> Dict[str, float]:
    """Validation: the mean per-line loss and, where the batches carry
    their texts and a codec is given, the greedy decode's CER, WER and
    sequence accuracy against them. Where every batch lacks texts (or no
    codec is given) but carries ``the_labels``, the CER is taken in label
    space instead and WER and sequence accuracy are NaN, as JAX's
    ``evaluate`` does (``crnn_ocr_tpu/train/loop.py:421-456``); with
    neither, all three are NaN."""
    losses, preds, refs = [], [], []
    dist_sum = ref_len_sum = label_batches = 0
    label_cer_ok = True
    for j, batch in enumerate(eval_iter):
        if j >= max_batches:
            break
        texts = batch.get("texts")
        loss_vec, decoded = eval_step(state, batch)
        losses.append(loss_vec.cpu().numpy())
        if codec is not None and texts is not None:
            label_cer_ok = False
            for row, ref in zip(ctc.trim_dense(decoded.cpu()), texts):
                preds.append(codec.labels_to_text(row))
                refs.append(ref)
        elif "the_labels" in batch:
            dist, ref_len = _label_distance(decoded, batch["the_labels"],
                                            batch["label_length"])
            dist_sum += dist
            ref_len_sum += ref_len
            label_batches += 1
        else:
            label_cer_ok = False
    out = {"loss": float(np.mean(np.concatenate(losses)))}
    if refs:
        out["cer"] = metrics_lib.cer(preds, refs)
        out["wer"] = metrics_lib.wer(preds, refs)
        out["seq_acc"] = metrics_lib.sequence_accuracy(preds, refs)
    elif label_cer_ok and label_batches:
        out.update(cer=dist_sum / max(ref_len_sum, 1), wer=float("nan"),
                   seq_acc=float("nan"))
    else:
        out.update(cer=float("nan"), wer=float("nan"), seq_acc=float("nan"))
    return out


def _label_distance(decoded, labels, label_length):
    """The summed edit distance between each line's decoded labels (the
    ``>= 0`` prefix of its row) and ``labels[:label_length]``, and the
    summed label lengths: the sums JAX's ``batched_levenshtein`` gives
    (``crnn_ocr_tpu/ops/editdistance.py``), on the host."""
    dec = decoded.cpu().numpy()
    lab = labels.cpu().numpy()
    lens = label_length.cpu().numpy().reshape(-1)
    dec_lens = (dec >= 0).sum(axis=1)
    dist = sum(metrics_lib.levenshtein(list(d[:n]), list(lb[:m]))
               for d, n, lb, m in zip(dec, dec_lens, lab, lens))
    return dist, int(lens.sum())
