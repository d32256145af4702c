"""Host ms a greedy ``predict`` call spends enqueueing the resize, pad and
standardize (``preprocess_batch``): the program's ``crnn.predict.resize``
span, over its ``crnn.predict`` spans."""

from portbench.program_spans import per_call


def read(obs):
    return per_call(obs, "resize")
