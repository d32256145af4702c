"""Host ms a train step spends in ``loss.backward()`` (autograd runs the
backward on its own thread while this one waits): the program's
``crnn.train.backward`` spans, over its ``crnn.train.step`` spans."""

from portbench.program_spans import STEP, host_ms


def read(obs):
    return host_ms(obs, ["crnn.train.backward"], STEP)
