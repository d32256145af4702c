"""Host ms a train step spends in the STN's forward: the program's
``crnn.stn.localize`` and ``crnn.stn.warp`` spans (``models/stn.py``), over
its ``crnn.train.step`` spans."""

from portbench.program_spans import STEP, host_ms


def read(obs):
    return host_ms(obs, ["crnn.stn.localize", "crnn.stn.warp"], STEP)
