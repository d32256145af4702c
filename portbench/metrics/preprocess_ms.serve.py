"""Host ms a ``predict`` call spends in the predictor's ``preprocess``
(pack, upload, resize, pad, standardize): the benchmark's ``pb.preprocess``
range, over the ``pb.predict`` calls of the traced window."""

from portbench.metrics_common import per_predict


def read(obs):
    return per_predict(obs, "preprocess")
