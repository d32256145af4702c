"""The STN's plain reference (``reference/stn.py``) against the port's CPU
path at a small size (height 32, width 64, 16 units, float32): the same
seeded weights, theta's Dense perturbed so that each image's theta departs
from the identity and K11's and K12's plain versions really sample. The
test imports the port; the reference does not
(``test_portbench_imports.py``).

Tolerances, each from float32 summed in other orders (the port's conv and
dense layers against the reference's, the gathers' sums in another
order): the warp on a hand-built theta 1e-5 absolute (samples of values
of order 1, each a sum of four products); the eval logits 1e-4 (as
``test_portbench_reference.py``: ten layers of such sums, two
recurrences); one training step's loss 1e-4 relative, each leaf's first
gradient norm 1e-3 of the larger of its norm and 1e-3, each leaf's change
1e-2 relative (Adam divides each element's step by its own gradient's
root, which amplifies the round-off of the tiniest gradients), as
``test_portbench_reference.py``.
"""

import numpy as np
import torch

from portbench.reference import model, stn

CONF = {"num_classes": 5, "height": 32, "width": 64, "stem_filters": 8,
        "block_filters": [8, 16, 16, 16],
        "block_pools": [[2, 2], [2, 1], [2, 1], [2, 1]],
        "time_dense_size": 16, "n_units": 16, "rnn_layers": 2,
        "rnn_cell": "gru", "dropout_rate": 0.2, "ctc_time_slice": 2,
        "dtype": "float32"}
FLAT = 4 * 8 * 32  # the localization net's flatten at 32x64
DENSE = ("time_dense.weight", "logits.weight", "stn.dense.weight",
         "stn.theta.weight")


def _weights(seed: int = 0):
    """Reference-layout leaves of a small STN CRNN."""
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
    feat = 16
    for i in range(2):
        W[f"birnn{i}.kernel"] = r(2, feat, 48)
        W[f"birnn{i}.recurrent_kernel"] = r(2, 16, 48)
        W[f"birnn{i}.bias"] = r(2, 2, 48)
        bn(f"rnn_bn{i}", 32)
        feat = 32
    W["logits.weight"], W["logits.bias"] = r(32, 6), r(6)
    W["stn.convs.0.weight"], W["stn.convs.0.bias"] = r(16, 1, 5, 5), r(16)
    W["stn.convs.1.weight"] = r(32, 16, 5, 5, scale=0.05)
    W["stn.convs.1.bias"] = r(32, scale=0.05)
    W["stn.dense.weight"] = r(FLAT, 50, scale=0.02)
    W["stn.dense.bias"] = r(50, scale=0.1)
    W["stn.theta.weight"] = r(50, 6, scale=0.05)
    W["stn.theta.bias"] = torch.tensor([0.9, 0.05, 0.03, -0.04, 0.85, 0.02])
    return W


def _port(W):
    from crnn_ocr_torch.config import ModelConfig
    from crnn_ocr_torch.models.crnn import CRNN

    cfg = ModelConfig(num_classes=5, height=32, width=64, stem_filters=8,
                      block_filters=(8, 16, 16, 16), time_dense_size=16,
                      n_units=16, use_stn=True)
    m = CRNN(cfg)
    m.load_state_dict({k: v.T.contiguous() if k in DENSE else v
                       for k, v in W.items()})
    return cfg, m


def _frames(seed=1, B=4):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(B, 32, 64, generator=g)


def test_the_warp_matches_the_port_on_a_hand_built_theta():
    from crnn_ocr_torch.ops.grid_sample import grid_sample_affine

    x = _frames(3, B=3)
    theta = torch.tensor([[1.0, 0.0, 0.0, 0.0, 1.0, 0.0],
                          [0.93, 0.11, -0.07, -0.05, 0.81, 0.12],
                          [1.2, -0.3, 0.4, 0.2, 1.1, -0.6]])
    want = grid_sample_affine(x[..., None], theta)[..., 0]
    torch.testing.assert_close(stn.warp(x, theta), want, rtol=0, atol=1e-5)
    # the identity reads every pixel back, up to the grid's rounding: a
    # point lands an ulp or so off its pixel, and the neighbour's weight
    # of ~1e-5 mixes a value differing by ~3 in
    torch.testing.assert_close(stn.warp(x, theta[:1].expand(3, 6)), x,
                               rtol=0, atol=1e-4)


def test_eval_logits_match_the_port():
    W = _weights()
    _, m = _port(W)
    x = _frames()
    with torch.no_grad():
        theta = stn.localize(W, x)
        assert float((theta - torch.tensor(
            [1.0, 0, 0, 0, 1.0, 0])).abs().min(1).values.max()) > 1e-3
        torch.testing.assert_close(theta, m.stn.localize(x), rtol=1e-5,
                                   atol=1e-5)
        want = m.eval()(x)
        got = stn.forward(W, x, CONF)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_a_training_step_matches_the_port():
    from crnn_ocr_torch.data.pipeline import produce_batch
    from crnn_ocr_torch.train.state import create_train_state
    from crnn_ocr_torch.train.step import make_train_step

    W = _weights(2)
    cfg, m = _port(W)
    state = create_train_state(cfg, m.state_dict(), device="cpu",
                               learning_rate=1e-3)
    B = 4
    canvas = np.full((B, 30, 70), 255, np.uint8)
    rng = np.random.default_rng(0)
    hs, ws = np.array([30, 24, 28, 20]), np.array([70, 50, 64, 40])
    for b in range(B):
        canvas[b, :hs[b], :ws[b]] = rng.integers(0, 256, (hs[b], ws[b]))
    host = {"the_input": canvas, "heights": hs.astype(np.int32),
            "widths": ws.astype(np.int32),
            "the_labels": np.array([[1, 2, 3, 0], [4, 0, 0, 0],
                                    [2, 2, 0, 0], [0, 1, 0, 0]], np.int32),
            "label_length": np.array([3, 1, 2, 2], np.int32), "bucket": 64}
    batch = produce_batch(dict(host), "cpu", cfg)
    batch = {k: v for k, v in batch.items() if k not in ("texts", "bucket")}
    named = dict(state.model.named_parameters())
    assert {k for k in named if k.startswith("stn.")} == {
        k for k in W if k.startswith("stn.")}
    p0 = {k: p.detach().clone() for k, p in named.items()}
    loss = float(make_train_step(cfg)(state, batch,
                                      torch.Generator().manual_seed(77))
                 ["loss"])
    mix = {"learning_rate": 1e-3, "clipnorm": 5.0}
    ref = stn.train_steps(W, [host], [77], CONF, mix, "cpu")
    assert abs(loss - ref["losses"][0]) <= 1e-4 * abs(ref["losses"][0])
    for k, p in named.items():
        g = float(state.optimizer.state[p]["exp_avg"].norm()) / 0.1
        assert abs(g - ref["grad1"][k]) <= 1e-3 * max(ref["grad1"][k],
                                                      1e-3), k
        d = float((p.detach() - p0[k]).norm())
        assert abs(d - ref["change"][k]) <= 1e-2 * max(ref["change"][k],
                                                       1e-6), k
    # theta's leaves learn: the warp's gradient reached them
    assert ref["grad1"]["stn.theta.bias"] > 0
    assert ref["grad1"]["stn.convs.0.weight"] > 0


def test_the_reference_reads_the_bundled_stn_leaves():
    from portbench import harness

    conf = harness.cell_plan(harness.load_benchmark(),
                             "train-warp-stn")["conf"]
    W = stn.load_weights(conf, harness.ROOT, "cpu")
    assert W["stn.convs.1.weight"].shape == (32, 16, 5, 5)
    assert W["stn.dense.weight"].shape == (4096, 50)
    assert W["stn.theta.bias"].shape == (6,)
    assert set(model.load_weights(conf, harness.ROOT, "cpu")) < set(W)


def test_the_stn_reference_imports_nothing_of_the_program():
    import json
    import os
    import subprocess
    import sys

    from portbench import harness

    code = ("import sys, json\n"
            "import portbench.reference.stn\n"
            "print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=harness.ROOT))
    assert out.returncode == 0, out.stderr
    mods = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not mods & ({"crnn_ocr_torch"} | set(harness.FORBIDDEN))
