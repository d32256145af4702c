"""Arithmetic that several per-layer readers (``metrics/``) share."""

from __future__ import annotations


def per_predict(obs, name: str):
    """Host ms of the benchmark's ``pb.<name>`` ranges a ``predict`` call."""
    calls = len(obs["host_ms"].get("predict", []))
    ms = obs["host_ms"].get(name)
    return sum(ms) / calls if ms and calls else None


def rnn_roofline(obs):
    """Least time over the kernel time under the ``pb.rnn`` ranges, %: the
    device time of the kernels each range launched (its children's
    included), one range a recurrent layer's call."""
    least = obs["rnn_least_s"]
    spent = obs["range_kernel_s"].get("pb.rnn", [])
    if not least or len(spent) != len(least) or sum(spent) <= 0:
        return None
    return 100.0 * sum(least) / sum(spent)


def mfu(obs):
    if not obs["lines"] or not obs["wall_s"]:
        return None
    return 100.0 * obs["flops"] / (obs["wall_s"] * obs["peak_flops"])
