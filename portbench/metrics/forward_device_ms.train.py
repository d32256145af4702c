"""Device ms a train step spends in the forward and the loss: the kernels
the program's ``crnn.train.forward`` and ``crnn.train.loss`` spans launched,
over its ``crnn.train.step`` spans."""

from portbench.program_spans import STEP, device_ms


def read(obs):
    return device_ms(obs, ["crnn.train.forward", "crnn.train.loss"], STEP)
