"""Host ms of the port's ``produce_batch`` (upload, resize, pad,
standardize on the card) a step, the device synchronized on both sides:
the benchmark's ``pb.produce_batch`` range."""


def read(obs):
    ms = obs["host_ms"].get("produce_batch")
    return sum(ms) / len(ms) if ms else None
