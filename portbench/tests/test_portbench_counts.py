"""The FLOP and byte counters against hand counts at one small shape."""

from portbench import counts

TINY = {"num_classes": 4, "height": 8, "stem_filters": 2,
        "block_filters": [4], "block_pools": [[2, 1]],
        "time_dense_size": 3, "n_units": 2, "rnn_layers": 1,
        "rnn_cell": "gru", "dtype": "bfloat16"}


def test_layer_flops_by_hand():
    # stem: 2 * 9 taps * 2 channels * 8 * 8 positions; then 4 x 4
    # block0: depthwise 2 * 9 * 2 * 16, pointwise 2 * 2 * 4 * 16; then 2 x 4
    # time_dense: 2 * T 4 * (2 * 4) * 3; the BiGRU (F 3, H 2, 6 gate
    # columns): projections 2 dirs * 2 * 4 * 3 * 6, recurrences 2 dirs *
    # 2 * 4 * 2 * 6; logits 2 * 4 * 4 * 5
    want = {"stem": 2304, "block0": 576 + 256, "time_dense": 192,
            "birnn0": 288 + 192, "logits": 160}
    assert counts.layer_flops(TINY, 8) == want
    assert counts.model_flops(TINY, 8) == 3968


def test_rnn_bytes_by_hand():
    # bf16: x (1, 4, 3), W (2, 3, 6), U (2, 2, 6), out (1, 4, 4); f32
    # biases (2, 2, 6)
    ops, moved = counts.rnn_cost(1, 4, 3, 2, "gru", 2)
    assert ops == 480
    assert moved == 2 * (12 + 36 + 24 + 16) + 4 * 24
    ops, moved = counts.rnn_cost(1, 4, 3, 2, "lstm", 2)
    assert ops == 2 * (2 * 4 * 3 * 8) + 2 * (2 * 4 * 2 * 8)
    assert moved == 2 * (12 + 48 + 32 + 16) + 4 * 16


def test_least_time_is_the_larger_bound():
    ops, moved = counts.rnn_cost(256, 64, 128, 256, "gru", 2)
    assert counts.rnn_least_s(256, 64, 128, 256, "gru", "bfloat16") == max(
        ops / 989e12, moved / 3.35e12)


def test_fonts_hard_line_at_bucket_256():
    import json
    import os

    from portbench import harness

    with open(os.path.join(harness.HERE, "configs", "fonts-hard.json")) as f:
        conf = json.load(f)
    assert counts.model_flops(conf, 256) == 387973120
