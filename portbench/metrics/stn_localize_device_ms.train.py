"""Device ms a train step spends in the STN's localization net: the cuDNN
and aten kernels the program's ``crnn.stn.localize`` spans launched, over
its ``crnn.train.step`` spans."""

from portbench.program_spans import STEP, device_ms


def read(obs):
    return device_ms(obs, ["crnn.stn.localize"], STEP)
