"""Host ms a greedy ``predict`` call spends decoding (``decode_dense`` and
the labels-to-text ``_predictions``): the benchmark's ``pb.decode`` ranges,
over the ``pb.predict`` calls of the traced window."""

from portbench.metrics_common import per_predict


def read(obs):
    return per_predict(obs, "decode")
