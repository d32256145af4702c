"""Host reads of a device value a beam ``predict`` call makes (the lengths
once, then one or two tier tests a frame): the count of the program's
``crnn.beam.sync`` spans over its ``crnn.predict`` spans."""

from portbench.program_spans import CALL, count


def read(obs):
    calls = count(obs, CALL)
    syncs = count(obs, "crnn.beam.sync")
    return syncs / calls if calls and syncs else None
