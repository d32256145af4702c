"""Host ms a train step spends copying its batch to the card (from pageable
memory: the copy waits for the step before on the stream): the program's
``crnn.data.upload`` spans, over its ``crnn.train.step`` spans."""

from portbench.program_spans import STEP, host_ms


def read(obs):
    return host_ms(obs, ["crnn.data.upload"], STEP)
