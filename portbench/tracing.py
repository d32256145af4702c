"""The traced run: the benchmark's own ranges around the program's layers,
the profiler over the traced window, and what the per-layer readers
(``metrics/``) read from both.

``Recorder.wrap`` opens a ``record_function`` range named ``pb.<name>``
around a call and keeps its host milliseconds; ``wrap_rnns`` does so around
each recurrent layer's forward and keeps the layer's least time on the
card (``counts.rnn_least_s``) from the shape it was called with.

``summarize`` reads the profiler's events once: the device's busy time
(the union of kernel, copy and set intervals, ranges excluded: the
arithmetic of ``chip_smoke.py::_trace_summary``), each range's host
durations and kernel time (its kernels' and its children's), and the
breakdown: the device operations that took most time, and the device's
idle gaps summed by the innermost host operation running when each began.
"""

from __future__ import annotations

import functools
import time
from collections import defaultdict
from typing import Callable, Dict, List

import numpy as np
import torch

from portbench import counts

PREFIX = "pb."
TOP = 10
NAME_CHARS = 160  # a kernel's name is cut to this in the breakdown


class Recorder:
    def __init__(self):
        self.host_ms: Dict[str, List[float]] = defaultdict(list)
        self.rnn_least_s: List[float] = []

    def wrap(self, name: str, fn: Callable) -> Callable:
        label = PREFIX + name

        @functools.wraps(fn)
        def wrapped(*a, **kw):
            t0 = time.perf_counter()
            with torch.profiler.record_function(label):
                out = fn(*a, **kw)
            self.host_ms[name].append((time.perf_counter() - t0) * 1e3)
            return out

        return wrapped

    def wrap_rnns(self, model, conf: dict) -> None:
        """Every recurrent layer of the program's model (a module with the
        configuration's ``units``; found by its attributes, not its class)."""
        for mod in model.modules():
            if getattr(mod, "units", None) == conf["n_units"] and \
                    hasattr(mod, "recurrent_kernel"):
                inner = self.wrap("rnn", mod.forward)

                def fwd(x, _inner=inner):
                    B, T, F = x.shape
                    self.rnn_least_s.append(counts.rnn_least_s(
                        B, T, F, conf["n_units"], conf["rnn_cell"],
                        conf["dtype"]))
                    return _inner(x)

                mod.forward = fwd


def _is_device(e) -> bool:
    return e.device_type == torch.autograd.DeviceType.CUDA


def _is_range(e) -> bool:
    return bool(getattr(e, "is_user_annotation", False)) or \
        e.name.startswith(PREFIX)


def summarize(prof) -> dict:
    events = list(prof.events())
    host = [e for e in events if not _is_device(e)]
    # a range's name on the device's timeline is not a kernel's
    range_names = {e.name for e in host if _is_range(e)}
    dev = [e for e in events if _is_device(e) and not _is_range(e)
           and e.name not in range_names]
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    merged: List[List[float]] = []
    for s, e in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy_us = sum(e - s for s, e in merged)
    by_kernel: Dict[str, float] = defaultdict(float)
    for e in dev:
        by_kernel[e.name] += e.time_range.end - e.time_range.start
    ranges_host: Dict[str, List[float]] = defaultdict(list)
    ranges_kernel: Dict[str, List[float]] = defaultdict(list)
    for e in host:
        if _is_range(e):
            ranges_host[e.name].append(
                (e.time_range.end - e.time_range.start) / 1e6)
            ranges_kernel[e.name].append(e.device_time_total / 1e6)
    return {"busy_s": busy_us / 1e6,
            "device_ops": sorted(((k[:NAME_CHARS], v / 1e6)
                                  for k, v in by_kernel.items()),
                                 key=lambda kv: -kv[1])[:TOP],
            "idle_gaps": _idle_gaps(merged, host),
            "range_host_s": dict(ranges_host),
            "range_kernel_s": dict(ranges_kernel)}


def _idle_gaps(merged, host, longest: int = 400):
    """The device's idle gaps (between busy intervals), the ``longest``
    of them each named by the innermost host operation running when it
    began, summed by name: the top ``TOP`` [name, seconds]."""
    gaps = [(merged[k + 1][0] - merged[k][1], merged[k][1])
            for k in range(len(merged) - 1)]
    gaps.sort(reverse=True)
    if not host:
        return []
    starts = np.array([e.time_range.start for e in host])
    ends = np.array([e.time_range.end for e in host])
    names = [e.name for e in host]
    total: Dict[str, float] = defaultdict(float)
    for length, at in gaps[:longest]:
        inside = np.nonzero((starts <= at) & (ends > at))[0]
        name = ("(host idle)" if len(inside) == 0 else
                names[inside[np.argmax(starts[inside])]])
        total[name] += length / 1e6
    return sorted(total.items(), key=lambda kv: -kv[1])[:TOP]


def profile(run: Callable[[], None], device: torch.device):
    """Run ``run`` under the profiler; (prof, wall seconds). The window is
    closed by a synchronize, so the wall holds all its device work."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    return prof, wall
