"""The serving recurrence's share of its roofline, %: each recurrent
layer's least time on the card (``counts.rnn_least_s``: its input
projection and both directions' recurrence, each operand moved once, from
the shape it was called with) over the device span of the benchmark's
``pb.rnn`` range around the layer's forward."""

from portbench.metrics_common import rnn_roofline


def read(obs):
    return rnn_roofline(obs)
