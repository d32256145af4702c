"""The train and eval steps (``crnn_ocr_tpu/train/step.py:83-244,
552-580``).

One train step: the model in training mode (batch-statistics BatchNorm,
dropout from the caller's generator) -> logits -> per-sample CTC loss after
the first ``ctc_time_slice`` frames -> each loss clipped at 1e4 -> their
plain mean -> backward -> Adam with the global-norm clip. On the card the
loss runs K6 forward and K7 backward, each BiGRU layer runs K3 forward
(each BiLSTM layer K5), and a non-STN model's stem runs K8 and K1 forward,
K9 and K10 backward; the recurrences' backwards are plain PyTorch.

Loss modes, as in the JAX package:

* ``exact_keras``: softmax, then ``ctc_batch_cost`` (``log(p + 1e-7)``,
  re-log-softmaxed): the reference's Keras loss;
* otherwise ``log_softmax`` straight into the CTC loss.

The masked mean and masked BatchNorm of padded data-parallel batches
belong to the data-parallel slice (ROADMAP item 13); a batch carrying a
``valid_mask`` raises.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from crnn_ocr_torch.config import ModelConfig
from crnn_ocr_torch.kernels.ctc_loss import ctc_loss
from crnn_ocr_torch.ops import ctc
from crnn_ocr_torch.train.state import TrainState, apply_gradients

LOSS_CLIP = 1e4  # an infeasible line's ~1e30 loss may not swamp the step


def step_seed(seed: int, step: int) -> int:
    """The dropout generator's seed for update ``step`` of a run seeded
    ``seed``: a hash of the pair (numpy's ``SeedSequence``), as the JAX
    step draws its key as ``fold_in(key(seed), step)``. A stream that
    depends on nothing else makes a resumed run draw a straight run's
    masks."""
    return int(np.random.SeedSequence([seed, step]).generate_state(
        1, np.uint64)[0])


def ctc_loss_vec(logits, labels, input_length, label_length,
                 ctc_time_slice: int = 2, exact_keras: bool = False):
    """(B,) CTC loss from raw logits (B, T, C), dropping the first
    ``ctc_time_slice`` frames; ``input_length`` counts frames after that
    slice."""
    sliced = logits[:, ctc_time_slice:, :]
    if exact_keras:
        probs = torch.softmax(sliced, dim=-1)
        return ctc.ctc_batch_cost(labels, probs, input_length,
                                  label_length)[:, 0]
    return ctc_loss(torch.log_softmax(sliced, dim=-1), labels, input_length,
                    label_length)


def loss_fn(model, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            exact_keras: bool = False,
            generator: Optional[torch.Generator] = None):
    """The forward half of a train step: (mean clipped loss, loss_vec)."""
    if batch.get("valid_mask") is not None:
        raise NotImplementedError(
            "valid_mask (padded data-parallel batches): the masked mean and "
            "masked BatchNorm are still to port (ROADMAP item 13)")
    logits = model(batch["x"], generator)
    loss_vec = ctc_loss_vec(logits, batch["the_labels"],
                            batch["input_length"], batch["label_length"],
                            cfg.ctc_time_slice, exact_keras)
    return torch.clamp(loss_vec, max=LOSS_CLIP).mean(), loss_vec


def make_train_step(cfg: ModelConfig, exact_keras: bool = False):
    """``train_step(state, batch, generator=None) -> metrics``: one update
    of ``state`` in place; ``metrics`` holds the ``loss`` and the
    ``grad_norm`` before clipping, as device scalars (reading them syncs)."""

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None):
        state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        loss, _ = loss_fn(state.model, batch, cfg, exact_keras, generator)
        loss.backward()
        gnorm = apply_gradients(state)
        return {"loss": loss.detach(), "grad_norm": gnorm}

    return train_step


def make_eval_step(cfg: ModelConfig):
    """``eval_step(state, batch) -> (loss_vec, decoded)``: the inference
    forward (eval mode, so K1 and K2 or K4 on the card), the per-line loss and
    the greedy decode (B, T') padded with -1."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Dict[str, torch.Tensor]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        model = state.model
        was_training = model.training
        model.eval()
        try:
            logits = model(batch["x"])
        finally:
            model.train(was_training)
        loss_vec = ctc_loss_vec(logits, batch["the_labels"],
                                batch["input_length"],
                                batch["label_length"], cfg.ctc_time_slice)
        probs = torch.softmax(logits[:, cfg.ctc_time_slice:, :], dim=-1)
        decoded, _ = ctc.ctc_greedy_decode(probs, batch["input_length"])
        return loss_vec, decoded

    return eval_step
