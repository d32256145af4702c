"""Host ms a greedy ``predict`` call waits for the card: the program's
``crnn.predict.wait`` span around the first read of the call's results (the
scores' ``.cpu()``), over its ``crnn.predict`` spans."""

from portbench.program_spans import per_call


def read(obs):
    return per_call(obs, "wait")
