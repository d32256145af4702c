"""The share of the beam's frames that neither the cheap proof nor the
eviction bound answers, %: the count of the program's ``crnn.beam.exact``
spans over that of its ``crnn.beam.frame`` spans."""

from portbench.program_spans import share


def read(obs):
    return share(obs, "crnn.beam.exact", "crnn.beam.frame")
