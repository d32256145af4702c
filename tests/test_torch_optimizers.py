"""Port parity: the optimizer menu (``crnn_ocr_torch/train/state.py::
make_optimizer`` and ``apply_gradients`` against ``crnn_ocr_tpu/train/
state.py::make_optimizer``, optax behind ``clip_by_global_norm``).

The same parameters and the same 5 seeded gradient sets (their global
norms on both sides of the clip's 5.0) go through optax and the port's
optimizer, under a cosine schedule with a linear warm-up. After every
update the parameters and every slot agree at rtol 1e-5 / atol 1e-7 in
f32 (the same arithmetic in another order: optax's schedule is evaluated
in f32, the port's in f64). A restored optimizer continues bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from crnn_ocr_torch.train import state as tstate
from crnn_ocr_torch.train.checkpoint import CheckpointManager
from crnn_ocr_tpu.train import state as jstate

SHAPES = {"a": (3, 4), "b": (5,), "c": (2, 3, 2)}  # sorted: optax's order
LR, TOTAL, WARMUP = 1e-2, 10, 2
# each optax slot's field name and the port's state key holding it
SLOTS = {
    "adam": {"mu": "exp_avg", "nu": "exp_avg_sq"},
    "adamw": {"mu": "exp_avg", "nu": "exp_avg_sq"},
    "sgd": {"trace": "momentum_buffer"},
    "rmsprop": {"nu": "nu"},
    "adadelta": {"e_g": "square_avg", "e_x": "acc_delta"},
}


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return {k: rng.normal(size=s).astype(np.float32)
            for k, s in SHAPES.items()}


def _grads(n=5, seed=1):
    """``n`` gradient sets; odd ones scaled past the clip's global norm."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        scale = 4.0 if i % 2 else 0.3
        out.append({k: (scale * rng.normal(size=s)).astype(np.float32)
                    for k, s in SHAPES.items()})
    return out


def _slot(opt_state, field):
    """The first optax state in ``opt_state`` with ``field``, as numpy."""
    if hasattr(opt_state, "_fields") and field in opt_state._fields:
        return {k: np.asarray(v) for k, v in getattr(opt_state,
                                                     field).items()}
    if isinstance(opt_state, (tuple, list)):
        for s in opt_state:
            found = _slot(s, field)
            if found is not None:
                return found
    return None


class _Params(torch.nn.Module):
    def __init__(self, params):
        super().__init__()
        self.p = torch.nn.ParameterList(
            torch.nn.Parameter(torch.from_numpy(params[k].copy()))
            for k in SHAPES)


def _port_state(name, params):
    model = _Params(params)
    return tstate.TrainState(
        model=model,
        optimizer=tstate.make_optimizer(name, model.parameters(), LR),
        schedule=tstate.make_schedule("cosine", LR, TOTAL, WARMUP),
        clipnorm=5.0)


def _port_update(state, grads):
    for p, k in zip(state.model.p, SHAPES):
        p.grad = torch.from_numpy(grads[k].copy())
    return float(tstate.apply_gradients(state))


@pytest.mark.parametrize("name", tstate.OPTIMIZERS)
def test_optimizer_matches_optax(name):
    params = _params()
    tx = jstate.make_optimizer(name, LR, clipnorm=5.0, schedule="cosine",
                               total_steps=TOTAL, warmup_steps=WARMUP)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jp)
    state = _port_state(name, params)
    norms = []
    for step, g in enumerate(_grads()):
        jg = {k: jnp.asarray(v) for k, v in g.items()}
        updates, opt_state = tx.update(jg, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        norms.append(_port_update(state, g))
        for p, k in zip(state.model.p, SHAPES):
            np.testing.assert_allclose(
                p.detach().numpy(), np.asarray(jp[k]), rtol=1e-5, atol=1e-7,
                err_msg=f"{name} step {step} param {k}")
        for field, key in SLOTS[name].items():
            want = _slot(opt_state, field)
            for p, k in zip(state.model.p, SHAPES):
                got = state.optimizer.state[p][key].numpy()
                np.testing.assert_allclose(
                    got, want[k], rtol=1e-5, atol=1e-7,
                    err_msg=f"{name} step {step} slot {field} {k}")
    assert state.step == 5
    assert min(norms) < 5.0 < max(norms)  # both sides of the clip ran


@pytest.mark.parametrize("name", tstate.OPTIMIZERS)
def test_restored_optimizer_continues_identically(name, tmp_path):
    grads = _grads()
    straight = _port_state(name, _params())
    for g in grads:
        _port_update(straight, g)
    first = _port_state(name, _params())
    for g in grads[:3]:
        _port_update(first, g)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    assert mgr.save(first.step, first)
    resumed = mgr.restore(_port_state(name, _params(seed=7)))
    assert resumed.step == 3
    for g in grads[3:]:
        _port_update(resumed, g)
    for a, b in zip(straight.model.p, resumed.model.p):
        assert torch.equal(a, b)
        for key, va in straight.optimizer.state[a].items():
            assert torch.equal(va, resumed.optimizer.state[b][key]), key
