"""Training: the train state and optimizers, the train and eval steps, the
fit loop and checkpoints."""

from crnn_ocr_torch.train.checkpoint import (
    CheckpointManager,
    load_codec,
    load_model_config,
)
from crnn_ocr_torch.train.loop import FitConfig, evaluate, fit
from crnn_ocr_torch.train.state import (
    TrainState,
    create_train_state,
    make_optimizer,
    param_count,
)
from crnn_ocr_torch.train.step import (
    make_cached_multi_train_step,
    make_eval_step,
    make_multi_train_step,
    make_partial_cached_multi_train_step,
    make_train_step,
)

__all__ = [
    "CheckpointManager",
    "FitConfig",
    "TrainState",
    "create_train_state",
    "evaluate",
    "fit",
    "load_codec",
    "load_model_config",
    "make_cached_multi_train_step",
    "make_eval_step",
    "make_multi_train_step",
    "make_optimizer",
    "make_partial_cached_multi_train_step",
    "make_train_step",
    "param_count",
]
