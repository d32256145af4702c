"""The fit loop and evaluation (``crnn_ocr_tpu/train/loop.py:29-459``),
single device, one train step per batch.

``fit`` runs the train step over a stream of device batches (from
``data.pipeline.produce_batch``), logs every ``log_every`` steps (loss, an
EMA of it, the gradient norm, lines/s) to stderr and to an optional JSONL
file, evaluates every ``eval_every`` steps with the greedy decoder (loss,
CER, WER, sequence accuracy) and stops early after ``early_stop_patience``
evaluations without a better CER. Reading a logged loss syncs with the
device, so the loop syncs at log points only.

Options of the JAX loop that belong to later slices raise
``NotImplementedError`` naming their ROADMAP item; none is ignored.
"""

from __future__ import annotations

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
from crnn_ocr_torch.train.state import TrainState
from crnn_ocr_torch.utils import metrics as metrics_lib


@dataclasses.dataclass
class FitConfig:
    steps: int = 1000  # total step budget, counted from state.step
    eval_every: int = 200
    eval_batches: int = 8
    early_stop_patience: int = 0  # 0 = off; evaluations without a better CER
    log_every: int = 50
    metrics_path: Optional[str] = None  # JSONL stream
    seed: int = 0  # the dropout generator's seed
    exact_keras_loss: bool = False
    # Not ported yet: each raises NotImplementedError when set.
    checkpoint_dir: Optional[str] = None  # ROADMAP item 8
    tensorboard_dir: Optional[str] = None  # ROADMAP item 8
    profile_dir: Optional[str] = None  # ROADMAP item 8
    steps_per_call: int = 1  # ROADMAP item 9 (K steps per dispatch)
    device_corpus: object = None  # ROADMAP item 9
    on_device_cer: bool = False  # ROADMAP item 12
    mesh: object = None  # ROADMAP item 13


_NOT_PORTED = (
    ("checkpoint_dir", 8, "checkpoints"),
    ("tensorboard_dir", 8, "TensorBoard logging"),
    ("profile_dir", 8, "the profiler window"),
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
    generator = torch.Generator(device=state.device).manual_seed(cfg.seed)
    best_cer = float("inf")
    evals_since_improve = 0
    ema_loss = None
    lines_seen = 0
    t_start = time.time()
    mfile = open(cfg.metrics_path, "a") if cfg.metrics_path else None
    try:
        for i, batch in enumerate(train_iter):
            if state.step >= cfg.steps:
                break
            batch = {k: v for k, v in batch.items()
                     if k not in ("texts", "bucket")}
            m = train_step(state, batch, generator)
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
                       "lines_per_sec": lines_seen / wall, "wall": wall}
                print(f"step {gstep:6d} loss {loss:9.4f} ema {ema_loss:9.4f} "
                      f"gnorm {rec['grad_norm']:8.3f} "
                      f"{rec['lines_per_sec']:8.1f} lines/s", file=sys.stderr)
                if mfile:
                    mfile.write(json.dumps(rec) + "\n")
                    mfile.flush()
            if eval_iter_fn and gstep % cfg.eval_every == 0:
                ev = evaluate(state, eval_step, eval_iter_fn(), codec,
                              cfg.eval_batches)
                ev["step"] = gstep
                print(f"eval  step {gstep}: loss {ev['loss']:.4f} "
                      f"CER {ev['cer']:.4f} WER {ev['wer']:.4f} "
                      f"acc {ev['seq_acc']:.4f}", file=sys.stderr)
                if mfile:
                    mfile.write(json.dumps({"kind": "eval", **ev}) + "\n")
                    mfile.flush()
                if ev["cer"] < best_cer - 1e-6:
                    best_cer = ev["cer"]
                    evals_since_improve = 0
                else:
                    evals_since_improve += 1
                    if (cfg.early_stop_patience and evals_since_improve
                            >= cfg.early_stop_patience):
                        print("early stopping", file=sys.stderr)
                        break
    finally:
        if mfile:
            mfile.close()
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
    sequence accuracy against them (NaN otherwise)."""
    losses, preds, refs = [], [], []
    for j, batch in enumerate(eval_iter):
        if j >= max_batches:
            break
        texts = batch.get("texts")
        loss_vec, decoded = eval_step(state, batch)
        losses.append(loss_vec.cpu().numpy())
        if codec is not None and texts is not None:
            for row, ref in zip(ctc.trim_dense(decoded.cpu()), texts):
                preds.append(codec.labels_to_text(row))
                refs.append(ref)
    out = {"loss": float(np.mean(np.concatenate(losses)))}
    if refs:
        out["cer"] = metrics_lib.cer(preds, refs)
        out["wer"] = metrics_lib.wer(preds, refs)
        out["seq_acc"] = metrics_lib.sequence_accuracy(preds, refs)
    else:
        out.update(cer=float("nan"), wer=float("nan"), seq_acc=float("nan"))
    return out
