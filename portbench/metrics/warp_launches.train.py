"""K11 and K12 launches a train step: the grid sampler's own launch
counters (``kernels/grid_sample.py``: ``launches``, ``bwd_launches``) over
the traced window, which the STN driver reads, over the window's steps.
1 and 1 where the warp's forward and backward stay on the kernels; their
plain versions (the CPU) count none."""


def read(obs):
    if "k11_launches" not in obs or not obs["units"]:
        return None
    return (obs["k11_launches"] + obs["k12_launches"]) / obs["units"]
