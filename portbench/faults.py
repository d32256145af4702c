"""Faults planted under the timed path, and the hooks that plant them: the
tests see ``correct`` come out false with each, and ``control.py`` reads
them on the card.

* ``altered_text``: every served line's first character replaced by the
  next class, as a decoder with a shifted class map would answer;
* ``frozen_state``: a train step that computes the loss and returns the
  state unchanged;
* ``half_batch``: a train step on the batch's first half, the loss's mean
  over that half.
"""

from __future__ import annotations

import torch


def _altered(text: str, alphabet: str) -> str:
    ch = text[:1] or alphabet[0]
    nxt = alphabet[(alphabet.index(ch) + 1) % len(alphabet)] \
        if ch in alphabet else alphabet[0]
    return nxt + text[1:]


def altered_text(classes) -> dict:
    alphabet = "".join(sorted(classes, key=classes.get))

    def hook(preds):
        for p in preds:
            p.text = _altered(p.text, alphabet)
        return preds

    return {"predictions": hook}


def frozen_state() -> dict:
    def wrap(step):
        def frozen(state, batch, generator=None):
            from crnn_ocr_torch.train.step import loss_fn

            with torch.no_grad():
                state.model.train()
                loss, _ = loss_fn(state.model, batch, state.model.cfg,
                                  generator=generator)
            return {"loss": loss, "grad_norm": torch.zeros_like(loss)}
        return frozen
    return {"train_step": wrap}


def half_batch() -> dict:
    def wrap(step):
        def half(state, batch, generator=None):
            n = int(batch["x"].shape[0]) // 2
            part = {k: v[:n] if torch.is_tensor(v) and v.dim() > 0 else v
                    for k, v in batch.items()}
            return step(state, part, generator)
        return half
    return {"train_step": wrap}


FAULTS = {"altered_text": altered_text, "frozen_state": frozen_state,
          "half_batch": half_batch}
