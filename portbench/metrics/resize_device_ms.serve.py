"""Device ms a greedy ``predict`` call spends in the resize, pad and
standardize: the kernels the program's ``crnn.predict.resize`` span
launched, over its ``crnn.predict`` spans. Beside ``resize_ms.serve`` it splits
the preprocessing between host and card."""

from portbench.program_spans import CALL, device_ms


def read(obs):
    return device_ms(obs, [CALL + ".resize"], CALL)
