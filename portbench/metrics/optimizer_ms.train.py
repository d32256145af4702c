"""Host ms a train step spends in the clip and the optimizer
(``apply_gradients``): the program's ``crnn.train.optimizer`` spans, over its
``crnn.train.step`` spans."""

from portbench.program_spans import STEP, host_ms


def read(obs):
    return host_ms(obs, ["crnn.train.optimizer"], STEP)
