"""Host ms of one frame of the beam's loop (its launches and tier tests):
the program's ``crnn.beam.frame`` spans over their count."""

from portbench.program_spans import host_ms

FRAME = "crnn.beam.frame"


def read(obs):
    return host_ms(obs, [FRAME], FRAME)
