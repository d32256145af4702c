"""Device ms a greedy ``predict`` call spends in the model and the softmax:
the kernels the program's ``crnn.predict.forward`` span launched, over its
``crnn.predict`` spans."""

from portbench.program_spans import CALL, device_ms


def read(obs):
    return device_ms(obs, [CALL + ".forward"], CALL)
