"""Checkpoints and exact resume (``crnn_ocr_tpu/train/checkpoint.py``).

The JAX package saves its whole train state through orbax; the port saves
the same parts with ``torch.save``, one directory per step:

  <directory>/<step>/checkpoint.pt   {"step", "model": the model's
                                      state_dict (parameters and BatchNorm
                                      running statistics), "optimizer": the
                                      optimizer's state_dict (its slots and
                                      step counts), "optimizer_name"}
  <directory>/<step>/metrics.json    the save's metrics, where the tracked
                                      metric is present and not NaN
  <directory>/model_config.json      as the JAX package writes them (its
  <directory>/classes.json           names and JSON shapes, read by either
  <directory>/metrics_<step>.json    package's ``load_model_config`` and
                                      ``load_codec``)

A save writes ``checkpoint.pt`` under a temporary name and renames it into
place, so a save cut off part-way leaves the earlier checkpoints readable;
a step directory without ``checkpoint.pt`` is not a checkpoint. A save at
a step not past the latest one is skipped, as orbax skips it. Rotation
keeps what orbax keeps with ``keep_checkpoints_without_metrics=True``:
with a tracked metric, the best ``max_to_keep`` saves by it and every save
without it; otherwise the newest ``max_to_keep``. Saves are synchronous:
``wait`` returns at once.

The files hold tensors and plain values only and are read with
``torch.load(..., weights_only=True)`` onto the CPU; ``restore`` copies
them into the given state on its own device, so a checkpoint written on
the card restores on the CPU and the reverse. A directory that orbax wrote
(``_CHECKPOINT_METADATA``, ``<step>/default``) raises ``OrbaxCheckpointError``:
reading the JAX package's checkpoints is migration work (ROADMAP item 15).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import shutil
from typing import Dict, List, Optional

import torch

from crnn_ocr_torch import config as config_lib
from crnn_ocr_torch.config import ModelConfig
from crnn_ocr_torch.data.codec import LabelCodec

CKPT_FILE = "checkpoint.pt"
METRICS_FILE = "metrics.json"


class OrbaxCheckpointError(NotImplementedError):
    """A checkpoint directory written by the JAX package's orbax."""


def _refuse_orbax(directory: str) -> None:
    """Raise where ``directory`` holds orbax's files: its
    ``_CHECKPOINT_METADATA`` or a ``<step>/default`` item."""
    names = os.listdir(directory) if os.path.isdir(directory) else []
    if "_CHECKPOINT_METADATA" in names or any(
            n.isdigit() and any(os.path.exists(os.path.join(directory, n, f))
                                for f in ("default", "_CHECKPOINT_METADATA"))
            for n in names):
        raise OrbaxCheckpointError(
            f"{directory}: an orbax checkpoint (the JAX package's); the port "
            "reads only its own checkpoints (<step>/checkpoint.pt). Reading "
            "orbax checkpoints is not ported yet (ROADMAP item 15, "
            "migration)")


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3,
                 track_metric: Optional[str] = None,
                 track_mode: str = "min"):
        """``track_metric`` (e.g. ``"cer"``) makes rotation keep the best
        ``max_to_keep`` checkpoints by that metric (``track_mode`` "min" or
        "max") instead of the newest; saves without it are always kept, so
        resume from the latest works beside them."""
        if track_mode not in ("min", "max"):
            raise ValueError(f"track_mode {track_mode!r}: 'min' or 'max'")
        self.directory = os.path.abspath(directory)
        _refuse_orbax(self.directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.track_metric = track_metric
        self.track_mode = track_mode

    # ---- the directory ----

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def all_steps(self) -> List[int]:
        """The saved steps, ascending."""
        return sorted(
            int(n) for n in os.listdir(self.directory)
            if n.isdigit() and os.path.exists(
                os.path.join(self.directory, n, CKPT_FILE)))

    def _tracked(self, step: int) -> Optional[float]:
        try:
            with open(os.path.join(self._step_dir(step), METRICS_FILE)) as f:
                return float(json.load(f)[self.track_metric])
        except (OSError, KeyError):
            return None

    def _by_metric(self, steps: List[int]) -> List[int]:
        """The steps with a tracked metric, the best last (orbax's order:
        a stable sort, descending for "min")."""
        scored = [(s, self._tracked(s)) for s in steps]
        scored = [(s, v) for s, v in scored if v is not None]
        scored.sort(key=lambda sv: sv[1], reverse=self.track_mode == "min")
        return [s for s, _ in scored]

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def best_step(self) -> Optional[int]:
        """The best step by the tracked metric, else the latest."""
        if self.track_metric is not None:
            ranked = self._by_metric(self.all_steps())
            if ranked:
                return ranked[-1]
        return self.latest_step()

    def _rotate(self) -> None:
        steps = self.all_steps()
        n = self.max_to_keep
        if n is None or len(steps) <= n:
            return
        if self.track_metric is None:
            keep = set(steps[-n:] if n else [])
        else:
            ranked = self._by_metric(steps)
            keep = set(ranked[-n:] if n else []) | (set(steps) - set(ranked))
        for s in steps:
            if s not in keep:
                shutil.rmtree(self._step_dir(s))

    # ---- save ----

    def save(self, step: int, state, model_cfg: Optional[ModelConfig] = None,
             codec: Optional[LabelCodec] = None,
             metrics: Optional[Dict[str, float]] = None) -> bool:
        """Save ``state`` (a ``TrainState``) as step ``step``, and beside
        the checkpoints ``model_config.json``, ``classes.json`` and
        ``metrics_<step>.json`` where given. Returns whether a checkpoint
        was written (not when ``step`` is not past the latest)."""
        step = int(step)
        latest = self.latest_step()
        saved = latest is None or step > latest
        if saved:
            d = self._step_dir(step)
            os.makedirs(d, exist_ok=True)
            tracked = (None if metrics is None or self.track_metric is None
                       else metrics.get(self.track_metric))
            mpath = os.path.join(d, METRICS_FILE)
            if tracked is not None and not math.isnan(float(tracked)):
                with open(mpath, "w") as f:
                    json.dump({k: float(v) for k, v in metrics.items()}, f)
            elif os.path.exists(mpath):  # left by a save cut off part-way
                os.remove(mpath)
            tmp = os.path.join(d, CKPT_FILE + ".tmp")
            torch.save({"step": int(state.step),
                        "model": state.model.state_dict(),
                        "optimizer": state.optimizer.state_dict(),
                        "optimizer_name": type(state.optimizer).__name__},
                       tmp)
            os.replace(tmp, os.path.join(d, CKPT_FILE))
            self._rotate()
        if model_cfg is not None:
            with open(os.path.join(self.directory, "model_config.json"),
                      "w") as f:
                json.dump(dataclasses.asdict(model_cfg), f, indent=1,
                          default=list)
        if codec is not None:
            codec.save(os.path.join(self.directory, "classes.json"))
        if metrics is not None:
            with open(os.path.join(self.directory, f"metrics_{step}.json"),
                      "w") as f:
                json.dump({k: float(v) for k, v in metrics.items()}, f,
                          indent=1)
        return saved

    def wait(self) -> None:
        """Saves are synchronous: nothing to wait for."""

    # ---- restore ----

    def _load(self, step: Optional[int]) -> dict:
        step = self.latest_step() if step is None else int(step)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        path = os.path.join(self._step_dir(step), CKPT_FILE)
        return torch.load(path, map_location="cpu", weights_only=True)

    def restore(self, state, step: Optional[int] = None):
        """Fill ``state`` (a ``TrainState`` of the same model and optimizer)
        in place from step ``step`` (default: the latest), on the state's
        own device; returns it."""
        payload = self._load(step)
        name = type(state.optimizer).__name__
        if payload["optimizer_name"] != name:
            raise ValueError(
                f"the checkpoint's optimizer is {payload['optimizer_name']}, "
                f"the state's {name}")
        state.model.load_state_dict(payload["model"])
        state.optimizer.load_state_dict(payload["optimizer"])
        state.step = int(payload["step"])
        return state

    def restore_inference(self, step: Optional[int] = None
                          ) -> Dict[str, torch.Tensor]:
        """The model's state_dict alone (CPU tensors), whatever optimizer
        wrote the checkpoint."""
        return self._load(step)["model"]


def load_model_config(directory: str) -> ModelConfig:
    """``<directory>/model_config.json``, the port's or the JAX package's
    (whose kernel-path knobs are dropped)."""
    return config_lib.load_model_config(
        os.path.join(directory, "model_config.json"))


def load_codec(directory: str) -> LabelCodec:
    return LabelCodec.load(os.path.join(directory, "classes.json"))
