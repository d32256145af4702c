"""The device's idle share of the traced window, %: 1 - (union of kernel,
copy and set intervals) / wall."""


def read(obs):
    if not obs["wall_s"] or not obs["busy_s"]:
        return None
    return 100.0 * (1.0 - obs["busy_s"] / obs["wall_s"])
