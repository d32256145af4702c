"""The whole step's share of the card's peak, %: the model's operations
for the lines the traced window completed, each at its bucket
(``counts.model_flops``; a train step three times its forward), over the
window's wall time times the dtype's peak."""

from portbench.metrics_common import mfu


def read(obs):
    return mfu(obs)
