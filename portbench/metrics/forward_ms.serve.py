"""Host ms a greedy ``predict`` call spends enqueueing the model and the
softmax: the program's ``crnn.predict.forward`` span, over its
``crnn.predict`` spans."""

from portbench.program_spans import per_call


def read(obs):
    return per_call(obs, "forward")
