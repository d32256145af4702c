"""Host ms a greedy ``predict`` call spends turning labels into text and
``Prediction``s: the program's ``crnn.predict.to_text`` span, over its
``crnn.predict`` spans."""

from portbench.program_spans import per_call


def read(obs):
    return per_call(obs, "to_text")
