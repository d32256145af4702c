"""Host ms a greedy ``predict`` call spends packing its canvas on the host:
the program's ``crnn.predict.pack`` span, over its ``crnn.predict`` spans."""

from portbench.program_spans import per_call


def read(obs):
    return per_call(obs, "pack")
