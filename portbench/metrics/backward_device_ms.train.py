"""Device ms a train step spends in the backward: the traced window's
busy ms a step, less the device ms of the step's other program spans
(``crnn.data.*``, ``crnn.train.forward``, ``.loss``, ``.optimizer``).

It is derived, not read from ``crnn.train.backward``: on CUDA autograd
launches the backward's kernels from its own device thread, and a span on
the main thread parents only what its own thread launches, so that span's
device time cannot hold them."""

from portbench.program_spans import STEP, count

OTHERS = ("crnn.data.upload", "crnn.data.resize", "crnn.data.augment",
          "crnn.train.forward", "crnn.train.loss", "crnn.train.optimizer")


def read(obs):
    steps = count(obs, STEP)
    others = sum(s for n in OTHERS for s in obs["range_kernel_s"].get(n, ()))
    if not steps or not obs["busy_s"] or others <= 0:
        return None
    return 1e3 * (obs["busy_s"] - others) / steps
