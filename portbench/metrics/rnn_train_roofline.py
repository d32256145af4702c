"""The training forward recurrence's share of its roofline, %: as
``rnn_serve_roofline``, over the ``pb.rnn`` ranges of the train steps."""

from portbench.metrics_common import rnn_roofline


def read(obs):
    return rnn_roofline(obs)
