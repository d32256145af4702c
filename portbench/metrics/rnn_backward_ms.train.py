"""Host ms a train step spends in the port's own ``bigru_backward`` or
``bilstm_backward`` ranges (the recurrences' backward loops), from the
profiler's trace."""

NAMES = ("bigru_backward", "bilstm_backward")


def read(obs):
    spans = [s for n in NAMES for s in obs["range_host_s"].get(n, [])]
    return sum(spans) * 1e3 / obs["units"] if spans and obs["units"] else None
