"""Host ms a beam ``predict`` call spends decoding (the TF-exact beam of
``decode_dense`` and ``_predictions``): the benchmark's ``pb.decode``
ranges, over the ``pb.predict`` calls of the traced window."""

from portbench.metrics_common import per_predict


def read(obs):
    return per_predict(obs, "decode")
