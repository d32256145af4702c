"""Host ms a greedy ``predict`` call spends copying its canvas, heights and
widths to the card (from pageable memory, so the host waits for the
stream): the program's ``crnn.predict.upload`` span, over its
``crnn.predict`` spans."""

from portbench.program_spans import per_call


def read(obs):
    return per_call(obs, "upload")
