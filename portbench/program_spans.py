"""Arithmetic of the per-layer readers (``metrics/``) that read the
program's own spans (``crnn_ocr_torch/utils/profiling.py::span``) from the
traced window, as ``tracing.summarize`` collects every user range: each
span's host seconds (``range_host_s``) and the device seconds of the
kernels it and its children on its thread launched (``range_kernel_s``).

A span's count in the window is its counter (the harness resets nothing,
so only a count within one window can be trusted). A ``predict`` call is
a ``crnn.predict`` span, a train step a ``crnn.train.step`` span. Every
reader returns None where its spans are absent: a program without them,
or device time on the CPU.
"""

from __future__ import annotations

from typing import Iterable, Optional

CALL = "crnn.predict"
STEP = "crnn.train.step"


def count(obs, name: str) -> int:
    return len(obs["range_host_s"].get(name, ()))


def host_ms(obs, names: Iterable[str], per: str) -> Optional[float]:
    """Host ms of the spans ``names`` over the count of the spans ``per``."""
    spans = [s for n in names for s in obs["range_host_s"].get(n, ())]
    units = count(obs, per)
    return 1e3 * sum(spans) / units if spans and units else None


def device_ms(obs, names: Iterable[str], per: str) -> Optional[float]:
    """Device ms of the kernels the spans ``names`` launched, over the
    count of the spans ``per``; None where they launched none."""
    total = sum(s for n in names for s in obs["range_kernel_s"].get(n, ()))
    units = count(obs, per)
    return 1e3 * total / units if total > 0 and units else None


def per_call(obs, stage: str) -> Optional[float]:
    """Host ms a ``predict`` call of its ``crnn.predict.<stage>`` span."""
    return host_ms(obs, [f"{CALL}.{stage}"], CALL)


def share(obs, part: str, whole: str) -> Optional[float]:
    """The count of the spans ``part`` over that of ``whole``, %."""
    n = count(obs, whole)
    return 100.0 * count(obs, part) / n if n else None
