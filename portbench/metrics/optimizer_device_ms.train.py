"""Device ms a train step spends in the clip and the optimizer: the kernels
the program's ``crnn.train.optimizer`` spans launched, over its
``crnn.train.step`` spans."""

from portbench.program_spans import STEP, device_ms


def read(obs):
    return device_ms(obs, ["crnn.train.optimizer"], STEP)
