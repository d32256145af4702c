"""Host ms a beam ``predict`` call spends in its reads of device values,
waiting for the card: the program's ``crnn.beam.sync`` spans, over its
``crnn.predict`` spans."""

from portbench.program_spans import CALL, host_ms


def read(obs):
    return host_ms(obs, ["crnn.beam.sync"], CALL)
