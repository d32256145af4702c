"""Operations and bytes of the CRNN's layers, counted from the
configuration's widths and the input's shape, whatever implements them;
and the H100's peaks they are held to.

Peaks: NVIDIA's data sheet for the H100 SXM, dense: 989e12 FLOP/s in
bf16 on the tensor cores, 67e12 in float32 off them, 3.35e12 bytes/s of
HBM.
"""

from __future__ import annotations

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12
ITEMSIZE = {"bfloat16": 2, "float32": 4}
GATES = {"gru": 3, "lstm": 4}
# a training step's operations against its forward's: the forward, then
# the backward's two products (inputs' and weights' gradients) a layer
TRAIN_FACTOR = 3

CONFIG_KEYS = ("num_classes", "height", "stem_filters", "time_dense_size",
               "n_units", "rnn_layers", "rnn_cell", "ctc_time_slice",
               "dtype")


def check_config(cfg, conf: dict) -> None:
    """Raise unless the program's model config has the file's widths."""
    got = {k: getattr(cfg, k) for k in CONFIG_KEYS}
    got["block_filters"] = list(cfg.block_filters)
    got["block_pools"] = [list(p) for p in cfg.block_pools]
    want = {k: conf[k] for k in got}
    if got != want:
        raise RuntimeError(f"the program's config {got} is not the "
                           f"benchmark's {want}")


def downsample(conf: dict) -> int:
    d = 2  # the stem's pool
    for _, pw in conf["block_pools"]:
        d *= pw
    return d


def layer_flops(conf: dict, width: int) -> dict:
    """Forward operations of one line at bucket ``width``, per layer (a
    multiply-add counts 2)."""
    H, W = conf["height"], width
    c = conf["stem_filters"]
    out = {"stem": 2 * 9 * c * H * W}
    H, W = H // 2, W // 2
    for i, (f, (ph, pw)) in enumerate(zip(conf["block_filters"],
                                         conf["block_pools"])):
        out[f"block{i}"] = 2 * 9 * c * H * W + 2 * c * f * H * W
        c, H, W = f, H // ph, W // pw
    T = W
    out["time_dense"] = 2 * T * H * c * conf["time_dense_size"]
    feat = conf["time_dense_size"]
    for i in range(conf["rnn_layers"]):
        out[f"birnn{i}"] = rnn_cost(1, T, feat, conf["n_units"],
                                    conf["rnn_cell"], 2)[0]
        feat = 2 * conf["n_units"]
    out["logits"] = 2 * T * feat * (conf["num_classes"] + 1)
    return out


def model_flops(conf: dict, width: int) -> int:
    return sum(layer_flops(conf, width).values())


def rnn_cost(B: int, T: int, F: int, H: int, cell: str, itemsize: int):
    """(operations, bytes) of one bidirectional recurrent layer on a (B, T,
    F) input: both directions' input projections and recurrences; its
    input, weights and biases read once and its (B, T, 2H) output written
    once."""
    g = GATES[cell] * H
    ops = 2 * (2 * B * T * F * g) + 2 * (2 * B * T * H * g)
    n_bias = 2 * 2 * g if cell == "gru" else 2 * g
    moved = itemsize * (B * T * F + 2 * F * g + 2 * H * g + B * T * 2 * H) \
        + 4 * n_bias
    return ops, moved


def rnn_least_s(B: int, T: int, F: int, H: int, cell: str,
                dtype: str) -> float:
    """The layer's least time on the card: the larger of its bytes over the
    HBM's rate and its operations over the dtype's peak."""
    ops, moved = rnn_cost(B, T, F, H, cell, ITEMSIZE[dtype])
    return max(moved / HBM_BYTES_PER_S, ops / PEAK_FLOPS[dtype])
