"""Port parity: K steps a call (``crnn_ocr_torch/train/step.py``'s
``make_multi_train_step``, ``data/pipeline.py``'s ``stack_host_batches``,
``fit``'s stacked path) against ``crnn_ocr_tpu``'s and against K single
steps.

Tolerances, as ``tests/test_train_multi.py`` holds JAX's scan to its
single steps: losses rtol 1e-5 / atol 1e-6; parameters and BatchNorm
statistics rtol 1e-3 / atol 1e-6; Adam's slots atol 2e-5. A stack pads
each canvas white to the group's quantized size, and a line that is its
batch's widest reads that padding once padded (in JAX too), so the two
need not be bitwise; the test reports whether they are. Against JAX's
``make_multi_train_step`` from the same weights (dropout 0, the XLA
recurrence and CTC on JAX's side, the plain versions on the port's): the
losses rtol 1e-4, as the train-parity tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crnn_ocr_torch.config import ModelConfig as TorchConfig
from crnn_ocr_torch.data import pipeline as tpipe
from crnn_ocr_torch.data.synthetic import SyntheticConfig as TSynthCfg
from crnn_ocr_torch.data.synthetic import SyntheticTextlines as TSynth
from crnn_ocr_torch.infer.weights import params_from_jax
from crnn_ocr_torch.train import loop as tloop
from crnn_ocr_torch.train import state as tstate
from crnn_ocr_torch.train import step as tstep
from crnn_ocr_tpu.data import pipeline as jpipe
from crnn_ocr_tpu.data.synthetic import SyntheticConfig as JSynthCfg
from crnn_ocr_tpu.data.synthetic import SyntheticTextlines as JSynth
from crnn_ocr_tpu.models import ModelConfig as JaxConfig
from crnn_ocr_tpu.train import state as jstate
from crnn_ocr_tpu.train import step as jstep

ALPHABET = "0123456789"
TINY = dict(num_classes=len(ALPHABET), width=64, stem_filters=8,
            block_filters=(12, 16, 16, 24), time_dense_size=16, n_units=16,
            rnn_layers=1, dropout_rate=0.1)
SEED = 7  # the dropout stream's


def _synth():
    return TSynth(TSynthCfg(alphabet=ALPHABET, min_len=2, max_len=4))


def _raw(n, bucket=64, seed=0, B=8, synth=None):
    return tpipe.synthetic_batches(batch_size=B, bucket=bucket, steps=n,
                                   seed=seed, synth=synth or _synth())


def _state(cfg, seed=0):
    return tstate.create_train_state(cfg, seed=seed, device="cpu")


def _single_steps(state, cfg, raw, augment=False, augment_seed=0):
    step = tstep.make_train_step(cfg)
    gen = torch.Generator()
    losses = []
    for b in tpipe.device_batches(raw, "cpu", cfg, prefetch=0,
                                  augment=augment,
                                  augment_seed=augment_seed):
        b.pop("texts"), b.pop("bucket")
        gen.manual_seed(tstep.step_seed(SEED, state.step))
        losses.append(float(step(state, b, gen)["loss"]))
    return losses


def _tensors(state):
    out = {f"model/{k}": v for k, v in state.model.state_dict().items()}
    for i, slots in state.optimizer.state_dict()["state"].items():
        out.update({f"opt/{i}/{k}": v for k, v in slots.items()})
    return out


def _assert_states_close(a, b):
    """JAX's scan-against-singles tolerances; True where bitwise."""
    ta, tb = _tensors(a), _tensors(b)
    assert ta.keys() == tb.keys() and a.step == b.step
    bitwise = True
    for k in ta:
        x, y = ta[k].float().numpy(), tb[k].float().numpy()
        bitwise = bitwise and np.array_equal(x, y)
        if k.startswith("opt/"):
            np.testing.assert_allclose(x, y, rtol=0, atol=2e-5, err_msg=k)
        else:
            np.testing.assert_allclose(x, y, rtol=1e-3, atol=1e-6, err_msg=k)
    return bitwise


def _interleaved(n_each=5):
    """Raw batches of two buckets, alternating, as one host stream: each
    package's own synthetic stream (byte-identical at equal arguments)."""
    def stream(pkg, synth):
        a = pkg.synthetic_batches(batch_size=4, bucket=64, seed=1,
                                  steps=n_each, synth=synth)
        b = pkg.synthetic_batches(batch_size=4, bucket=128, seed=2,
                                  steps=n_each, synth=synth)
        for x, y in zip(a, b):
            yield x
            yield y
    return (stream(tpipe, _synth()),
            stream(jpipe, JSynth(JSynthCfg(alphabet=ALPHABET, min_len=2,
                                           max_len=4))))


@pytest.mark.parametrize("n_inner,offset", [(2, 0), (3, 5), (1, 0)])
def test_stack_host_batches_is_byte_equal_to_jax(n_inner, offset):
    t_raw, j_raw = _interleaved()
    got = list(tpipe.stack_host_batches(t_raw, n_inner, prefetch=0,
                                        index_offset=offset))
    want = list(jpipe.stack_host_batches(j_raw, n_inner, prefetch=2,
                                         index_offset=offset))
    assert len(got) == len(want)
    n_stacks = 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        n_stacks += "stacked" in g
        for k, v in w.items():
            if isinstance(v, np.ndarray):
                assert g[k].dtype == v.dtype, k
                np.testing.assert_array_equal(g[k], v, err_msg=k)
            else:
                assert g[k] == v, k
    if n_inner > 1:
        # two buckets of 5: two stacks each at K 2 (one batch of each
        # flushed), one each at K 3 (two flushed)
        assert n_stacks == {2: 4, 3: 2}[n_inner]
        idx = sorted([int(i) for b in got if "stacked" in b
                      for i in b["batch_index"]]
                     + [int(b["batch_index"]) for b in got
                        if "stacked" not in b])
        assert idx == list(range(offset, offset + 10))


def test_multi_step_matches_k_single_steps():
    """One K = 3 call equals 3 single steps (dropout 0.1): the per-step
    losses, the updated parameters, BatchNorm statistics and Adam slots."""
    cfg = TorchConfig(**TINY)
    a, b = _state(cfg), _state(cfg)
    losses = _single_steps(a, cfg, _raw(3))
    stack, = tpipe.stack_host_batches(_raw(3), 3, prefetch=0)
    assert stack["stacked"] == 3
    ms = tstep.make_multi_train_step(cfg)(b, stack, SEED, stack["bucket"])
    assert ms["loss"].shape == ms["grad_norm"].shape == (3,)
    np.testing.assert_allclose(ms["loss"].numpy(), losses, rtol=1e-5,
                               atol=1e-6)
    _assert_states_close(a, b)


def test_multi_step_augment_stream_matches_single_path():
    """With augmentation, the K-step call draws each batch's augmentation
    from its ``batch_index``, as ``device_batches`` draws index n for its
    n-th batch (``tests/test_train_multi.py:195``)."""
    cfg = TorchConfig(**TINY)
    a, b = _state(cfg), _state(cfg)
    losses = _single_steps(a, cfg, _raw(3), augment=True, augment_seed=21)
    stack, = tpipe.stack_host_batches(_raw(3), 3, prefetch=0)
    multi = tstep.make_multi_train_step(cfg, augment=True, augment_seed=21)
    ms = multi(b, stack, SEED, stack["bucket"])
    np.testing.assert_allclose(ms["loss"].numpy(), losses, rtol=1e-5,
                               atol=1e-6)
    _assert_states_close(a, b)
    # and the augmentation did change the steps
    c = _state(cfg)
    plain = tstep.make_multi_train_step(cfg)(c, stack, SEED, stack["bucket"])
    assert not torch.equal(plain["loss"], ms["loss"])


def test_multi_step_matches_jax_multi_step():
    """The port's K = 2 call against JAX's ``make_multi_train_step`` at the
    same weights and stack (dropout 0): losses rtol 1e-4."""
    kw = dict(TINY, dropout_rate=0.0)
    jcfg = JaxConfig(**kw, use_pallas_rnn=False, use_fused_stem=False)
    js = jstate.create_train_state(jcfg, jax.random.key(0), batch_size=8)
    init = (jax.tree_util.tree_map(np.asarray, js.params),
            jax.tree_util.tree_map(np.asarray, js.batch_stats))
    raw = jpipe.synthetic_batches(
        batch_size=8, bucket=64, steps=2, seed=3,
        synth=JSynth(JSynthCfg(alphabet=ALPHABET, min_len=2, max_len=4)))
    stack, = jpipe.stack_host_batches(raw, 2, prefetch=0)
    multi = jstep.make_multi_train_step(jcfg, donate=False,
                                        use_pallas_ctc=False)
    jst = {k: stack[k] for k in ("the_input", "heights", "widths",
                                 "the_labels", "label_length",
                                 "batch_index")}
    js, jm = multi(js, {k: jnp.asarray(v) for k, v in jst.items()},
                   jax.random.key(0), bucket=64)
    cfg = TorchConfig(**kw)
    ts = tstate.create_train_state(cfg, params_from_jax(*init), device="cpu")
    tm = tstep.make_multi_train_step(cfg)(ts, stack, 0, 64)
    assert ts.step == int(js.step) == 2
    np.testing.assert_allclose(tm["loss"].numpy(), np.asarray(jm["loss"]),
                               rtol=1e-4)
    np.testing.assert_allclose(tm["grad_norm"].numpy(),
                               np.asarray(jm["grad_norm"]), rtol=1e-3)


def _fit(cfg, stream, steps, **kw):
    state = _state(cfg)
    return tloop.fit(state, cfg, stream, cfg=tloop.FitConfig(
        steps=steps, log_every=2, eval_every=100, seed=SEED, **kw))


def test_fit_steps_per_call_matches_single_step_fit():
    """``fit(steps_per_call=2)`` over a single-bucket stream reaches the
    single-step ``fit``'s state (the same batches in the same order)."""
    cfg = TorchConfig(**TINY)
    one = _fit(cfg, tpipe.device_batches(_raw(6), "cpu", cfg, prefetch=0), 6)
    two = _fit(cfg, tpipe.stack_host_batches(_raw(6), 2, prefetch=0), 6,
               steps_per_call=2)
    assert one.step == two.step == 6
    _assert_states_close(one, two)


def test_fit_trims_the_last_stack_to_the_budget():
    """A budget that K does not divide is reached exactly: the last stack
    is cut; and a stream's flushed partial group runs as single steps
    with its own augmentation index."""
    cfg = TorchConfig(**TINY)
    out = _fit(cfg, tpipe.stack_host_batches(_raw(6), 2, prefetch=0), 5,
               steps_per_call=2)
    assert out.step == 5
    # 5 batches at K 2: two stacks and one flushed batch, augmented
    aug = dict(augment=True, augment_seed=3)
    flushed = _fit(cfg, tpipe.stack_host_batches(_raw(5), 2, prefetch=0), 5,
                   steps_per_call=2, **aug)
    singles = _fit(cfg, tpipe.device_batches(_raw(5), "cpu", cfg,
                                             prefetch=0, **aug), 5)
    assert flushed.step == singles.step == 5
    _assert_states_close(flushed, singles)
