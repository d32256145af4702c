"""Train state: the model, its optimizer, the learning-rate schedule and
the step count (``crnn_ocr_tpu/train/state.py:26-128``).

The JAX package's ``optax.chain(clip_by_global_norm(5.0), <optimizer>)``
menu (``make_optimizer``) becomes a ``torch.optim`` optimizer with optax's
defaults (``make_optimizer`` here): ``adam`` (betas 0.9 / 0.999, eps
1e-8), ``sgd`` (momentum 0.9), ``rmsprop`` (decay 0.9, eps 1e-8 inside
the square root: ``RMSprop`` below, since ``torch.optim.RMSprop`` decays
at 0.99 and adds eps outside the root), ``adadelta`` (rho 0.9, eps 1e-6)
and ``adamw`` (Adam's, with weight decay 1e-4 on every parameter, biases
and BatchNorm included, as optax's unmasked default), each behind a clip
written as optax writes it: every gradient is scaled by
``max_norm / g_norm``, as ``(g / g_norm) * max_norm``, only when
``g_norm >= max_norm`` (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to
the norm and clips whenever the norm exceeds it, so it does not match).
The schedule's learning rate for update ``k`` (counted from 0) is set on
the optimizer before that update, as optax evaluates its schedule at the
update count.

``create_train_state`` starts from given weights (fine-tuning) or from a
seeded init with flax's initializer families (lecun-normal convolutions
and dense layers, glorot-uniform input and orthogonal recurrent GRU and
LSTM kernels, zero biases but the LSTM's unit forget bias, unit BatchNorm
scales; the STN's theta layer with a zero kernel and the identity bias): the same distributions as the JAX
package's ``model.init``, not the same numbers.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import torch

from crnn_ocr_torch.config import ModelConfig
from crnn_ocr_torch.infer.predictor import resolve_device
from crnn_ocr_torch.models.crnn import CRNN
from crnn_ocr_torch.models.rnn import BiRNN
from crnn_ocr_torch.models.stn import IDENTITY

ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8
OPTIMIZERS = ("adam", "sgd", "rmsprop", "adadelta", "adamw")


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    """optax.linear_schedule: ``init`` to ``end`` over ``steps`` updates,
    then ``end``."""

    def fn(count: int) -> float:
        frac = 1.0 - min(max(count, 0), steps) / steps if steps > 0 else 0.0
        return (init - end) * frac + end

    return fn


def _join(schedules, boundaries) -> Callable[[int], float]:
    """optax.join_schedules: schedule ``i`` from boundary ``i - 1`` on, fed
    the count since that boundary."""

    def fn(count: int) -> float:
        i = sum(count >= b for b in boundaries)
        start = boundaries[i - 1] if i > 0 else 0
        return schedules[i](count - start)

    return fn


def make_schedule(name: str, learning_rate: float, total_steps: int = 10_000,
                  warmup_steps: int = 0) -> Callable[[int], float]:
    """The JAX package's schedules: ``constant``, ``cosine`` (to 0 over
    ``total_steps``), ``cyclic`` (triangular between lr/10 and lr, period
    ``max(total_steps // 8, 100)``, 8 cycles), each after an optional
    linear warm-up from 0."""
    name = (name or "constant").lower()
    if name == "constant":
        sched = lambda count: learning_rate  # noqa: E731
    elif name == "cosine":
        decay = max(total_steps, 1)

        def sched(count: int) -> float:
            c = min(count, decay)
            return learning_rate * 0.5 * (1.0 + math.cos(math.pi * c / decay))
    elif name == "cyclic":
        period = max(total_steps // 8, 100)
        up, down = period // 2, period - period // 2
        parts = [_linear(learning_rate / 10, learning_rate, up),
                 _linear(learning_rate, learning_rate / 10, down)] * 8
        bounds, acc = [], 0
        for n in [up, down] * 8:
            acc += n
            bounds.append(acc)
        sched = _join(parts, bounds[:-1])
    else:
        raise ValueError(f"unknown schedule {name!r}")
    if warmup_steps:
        sched = _join([_linear(0.0, learning_rate, warmup_steps), sched],
                      [warmup_steps])
    return sched


class RMSprop(torch.optim.Optimizer):
    """``optax.rmsprop``'s update (not centered, no momentum): per element
    ``nu = (1 - decay) * g**2 + decay * nu`` from ``nu = 0``, then
    ``p -= lr * g * rsqrt(nu + eps)``. Its one slot is ``state[p]["nu"]``.
    """

    def __init__(self, params, lr: float = 1e-3, decay: float = 0.9,
                 eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("RMSprop.step takes no closure")
        for group in self.param_groups:
            lr, decay, eps = group["lr"], group["decay"], group["eps"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["nu"] = torch.zeros_like(
                        p, memory_format=torch.preserve_format)
                g, nu = p.grad, state["nu"]
                nu.copy_((1 - decay) * g.square() + decay * nu)
                p.sub_(lr * (g * torch.rsqrt(nu + eps)))


def make_optimizer(name: str, params, learning_rate: float = 1e-3
                   ) -> torch.optim.Optimizer:
    """One of the JAX package's optimizers (``OPTIMIZERS``) over
    ``params``, with optax's defaults; the clip and the schedule are
    ``apply_gradients``'s."""
    name = name.lower()
    lr = learning_rate
    if name == "adam":
        return torch.optim.Adam(params, lr=lr, betas=ADAM_BETAS, eps=ADAM_EPS)
    if name == "sgd":
        return torch.optim.SGD(params, lr=lr, momentum=0.9)
    if name == "rmsprop":
        return RMSprop(params, lr=lr)
    if name == "adadelta":
        return torch.optim.Adadelta(params, lr=lr, rho=0.9, eps=1e-6)
    if name == "adamw":
        return torch.optim.AdamW(params, lr=lr, betas=ADAM_BETAS,
                                 eps=ADAM_EPS, weight_decay=1e-4)
    raise ValueError(f"unknown optimizer {name!r}")


@dataclasses.dataclass
class TrainState:
    model: CRNN
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]
    clipnorm: float = 5.0
    step: int = 0

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device


def global_norm(tensors) -> torch.Tensor:
    """optax.global_norm: sqrt of the sum of every element's square, f32."""
    return torch.sqrt(sum(t.float().pow(2).sum() for t in tensors))


def apply_gradients(state: TrainState) -> torch.Tensor:
    """Clip the gradients by their global norm (optax's rule, on the device
    with no host sync), take one optimizer update at the schedule's rate,
    count the step. Returns the global norm before clipping."""
    params = [p for p in state.model.parameters() if p.grad is not None]
    grads = [p.grad for p in params]
    g_norm = global_norm(grads)
    if state.clipnorm:
        trigger = g_norm < state.clipnorm
        for g in grads:
            g.copy_(torch.where(trigger, g, g / g_norm * state.clipnorm))
    for group in state.optimizer.param_groups:
        group["lr"] = state.schedule(state.step)
    state.optimizer.step()
    state.step += 1
    return g_norm


def _lecun_normal_(w: torch.Tensor, fan_in: int, gen) -> None:
    """flax lecun_normal: truncated normal on [-2, 2] std, variance 1/fan_in,
    std corrected for the truncation."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    torch.nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=gen)


def _glorot_uniform_(w: torch.Tensor, fan_in: int, fan_out: int, gen) -> None:
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    torch.nn.init.uniform_(w, -limit, limit, generator=gen)


def _orthogonal_(w: torch.Tensor, gen) -> None:
    """flax orthogonal (column axis last) over the flattened (rows, cols)."""
    cols = w.shape[-1]
    rows = w.numel() // cols
    a = torch.randn(max(rows, cols), min(rows, cols), generator=gen)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))
    if rows < cols:
        q = q.T
    w.copy_(q.reshape(w.shape))


@torch.no_grad()
def init_weights(model: CRNN, seed: int = 0) -> None:
    """Seeded init with flax's families, in the JAX layouts' fan terms."""
    gen = torch.Generator().manual_seed(seed)
    for mod in model.modules():
        if isinstance(mod, torch.nn.Conv2d):
            # HWIO fan_in = kh * kw * in / groups
            fan_in = mod.weight[0].numel()
            _lecun_normal_(mod.weight, fan_in, gen)
            if mod.bias is not None:  # the STN's convolutions
                mod.bias.zero_()
        elif isinstance(mod, torch.nn.Linear):
            _lecun_normal_(mod.weight, mod.in_features, gen)
            mod.bias.zero_()
    for mod in model.modules():
        if isinstance(mod, BiRNN):
            # kernel (2, F, nH): flax fans count the leading 2 as a
            # receptive field
            _, f, g = mod.kernel.shape
            _glorot_uniform_(mod.kernel, 2 * f, 2 * g, gen)
            _orthogonal_(mod.recurrent_kernel, gen)
            mod.bias.zero_()
            if mod.cell == "lstm":  # Keras unit_forget_bias (rnn.py:90-97)
                mod.bias[..., mod.units:2 * mod.units] = 1.0
    for mod in model.modules():
        if hasattr(mod, "running_var"):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
            mod.running_mean.zero_()
            mod.running_var.fill_(1.0)
    if model.stn is not None:  # theta starts at the identity transform
        model.stn.theta.weight.zero_()
        model.stn.theta.bias.copy_(torch.tensor(IDENTITY))


def create_train_state(
    cfg: ModelConfig,
    state_dict: Optional[Dict[str, torch.Tensor]] = None,
    seed: int = 0,
    device="cuda",
    optimizer: str = "adam",
    learning_rate: float = 1e-3,
    clipnorm: float = 5.0,
    schedule: str = "constant",
    total_steps: int = 10_000,
    warmup_steps: int = 0,
) -> TrainState:
    """A model in training mode on ``device`` (CUDA unless the caller asks
    for the CPU), from ``state_dict`` or a seeded init, with its optimizer
    (one of ``OPTIMIZERS``)."""
    dev = resolve_device(device)
    model = CRNN(cfg)
    if state_dict is None:
        init_weights(model, seed)
    else:
        model.load_state_dict(state_dict)
    model.to(dev).train()
    return TrainState(
        model=model,
        optimizer=make_optimizer(optimizer, model.parameters(),
                                 learning_rate),
        schedule=make_schedule(schedule, learning_rate, total_steps,
                               warmup_steps),
        clipnorm=clipnorm)
