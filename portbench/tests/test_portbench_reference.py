"""The plain reference against the port's CPU path at a small size: the
same seeded weights, float32. The test imports the port; the reference
does not (``test_portbench_imports.py``)."""

import numpy as np
import pytest
import torch

from portbench.reference import ctc, model

CONF = {"num_classes": 5, "height": 32, "width": 64, "stem_filters": 8,
        "block_filters": [8, 16, 16, 16],
        "block_pools": [[2, 2], [2, 1], [2, 1], [2, 1]],
        "time_dense_size": 16, "n_units": 16, "rnn_layers": 2,
        "dropout_rate": 0.2, "ctc_time_slice": 2, "dtype": "float32"}


def _weights(cell: str, seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s, scale=0.3: torch.randn(*s, generator=g) * scale  # noqa
    W = {"stem_conv.weight": r(8, 1, 3, 3)}

    def bn(key, c):
        W.update({f"{key}.weight": 1 + r(c, scale=0.1),
                  f"{key}.bias": r(c, scale=0.1),
                  f"{key}.running_mean": r(c, scale=0.1),
                  f"{key}.running_var": 1 + r(c, scale=0.1).abs()})

    bn("stem_bn", 8)
    c = 8
    for i, f in enumerate(CONF["block_filters"]):
        W[f"block{i}.depthwise.weight"] = r(c, 1, 3, 3)
        W[f"block{i}.pointwise.weight"] = r(f, c, 1, 1)
        bn(f"block{i}.bn", f)
        c = f
    W["time_dense.weight"], W["time_dense.bias"] = r(16, 16), r(16)
    feat, n = 16, {"gru": 3, "lstm": 4}[cell]
    for i in range(2):
        W[f"birnn{i}.kernel"] = r(2, feat, n * 16)
        W[f"birnn{i}.recurrent_kernel"] = r(2, 16, n * 16)
        W[f"birnn{i}.bias"] = r(*((2, 2, 48) if cell == "gru" else (2, 64)))
        bn(f"rnn_bn{i}", 32)
        feat = 32
    W["logits.weight"], W["logits.bias"] = r(32, 6), r(6)
    return W


def _port(cell: str, W):
    from crnn_ocr_torch.config import ModelConfig
    from crnn_ocr_torch.models.crnn import CRNN

    cfg = ModelConfig(num_classes=5, height=32, width=64, stem_filters=8,
                      block_filters=(8, 16, 16, 16),
                      time_dense_size=16, n_units=16, rnn_cell=cell)
    m = CRNN(cfg)
    sd = {k: v.T.contiguous() if k in ("time_dense.weight", "logits.weight")
          else v for k, v in W.items()}
    m.load_state_dict(sd)
    return cfg, m


def _frames(seed=1, B=4):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(B, 32, 64, generator=g)


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_eval_logits_match_the_port(cell):
    W = _weights(cell)
    conf = dict(CONF, rnn_cell=cell)
    _, m = _port(cell, W)
    x = _frames()
    with torch.no_grad():
        want = m.eval()(x)
        got = model.forward(W, x, conf)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_training_step_matches_the_port(cell):
    from crnn_ocr_torch.train.state import create_train_state
    from crnn_ocr_torch.train.step import make_train_step

    W = _weights(cell, 2)
    conf = dict(CONF, rnn_cell=cell)
    cfg, m = _port(cell, W)
    state = create_train_state(cfg, m.state_dict(), device="cpu",
                               learning_rate=1e-3)
    B = 4
    canvas = np.full((B, 30, 70), 255, np.uint8)
    rng = np.random.default_rng(0)
    hs, ws = np.array([30, 24, 28, 20]), np.array([70, 50, 64, 40])
    for b in range(B):
        canvas[b, :hs[b], :ws[b]] = rng.integers(0, 256, (hs[b], ws[b]))
    labels = np.array([[1, 2, 3, 0], [4, 0, 0, 0], [2, 2, 0, 0],
                       [0, 1, 0, 0]], np.int32)
    lab_len = np.array([3, 1, 2, 2], np.int32)
    host = {"the_input": canvas, "heights": hs.astype(np.int32),
            "widths": ws.astype(np.int32), "the_labels": labels,
            "label_length": lab_len, "bucket": 64}
    from crnn_ocr_torch.data.pipeline import produce_batch

    batch = produce_batch(dict(host), "cpu", cfg)
    batch = {k: v for k, v in batch.items() if k not in ("texts", "bucket")}
    x_ref, len_ref = model.batch_frames(host, conf, "cpu")
    torch.testing.assert_close(x_ref, batch["x"], rtol=1e-5, atol=1e-4)
    assert len_ref.tolist() == batch["input_length"].tolist()

    named = dict(state.model.named_parameters())
    p0 = {k: p.detach().clone() for k, p in named.items()}
    gen = torch.Generator().manual_seed(77)
    loss = float(make_train_step(cfg)(state, batch, gen)["loss"])
    mix = {"learning_rate": 1e-3, "clipnorm": 5.0}
    ref = model.train_steps(W, [host], [77], conf, mix, "cpu")
    assert abs(loss - ref["losses"][0]) <= 1e-4 * abs(ref["losses"][0])
    for k, p in named.items():
        g = float(state.optimizer.state[p]["exp_avg"].norm()) / 0.1
        assert abs(g - ref["grad1"][k]) <= 1e-3 * max(ref["grad1"][k], 1e-3)
        d = float((p.detach() - p0[k]).norm())
        assert abs(d - ref["change"][k]) <= 1e-2 * max(ref["change"][k],
                                                       1e-6), k


def test_ctc_lattice_on_a_hand_example():
    # two frames, classes {a, blank}: P(a) = p(a,a) + p(a,-) + p(-,a)
    p = np.array([[0.6, 0.4], [0.3, 0.7]])
    lp = np.log(p)
    want = 0.6 * 0.3 + 0.6 * 0.7 + 0.4 * 0.3
    assert np.isclose(ctc.log_likelihood(lp, [0]), np.log(want))
    assert np.isclose(ctc.best_path(lp, [0]), np.log(0.6 * 0.7))
    assert ctc.greedy(lp) == ([0], float(np.log(0.6) + np.log(0.7)))
    assert ctc.best_path(lp, [0, 0]) == -np.inf  # needs a blank between
