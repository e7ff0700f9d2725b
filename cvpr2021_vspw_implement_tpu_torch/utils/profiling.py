"""Tracing and step timing (JAX counterpart: utils/profiling.py; the
reference has none but its per-iteration ``AverageMeter`` prints).

* :func:`trace` — ``torch.profiler`` over a block, host ops and, on a card,
  its kernels (CUPTI), written on exit as a Chrome trace
  (``export_chrome_trace``; no tensorboard package needed), which
  ``chrome://tracing`` or Perfetto opens;
* :func:`annotate` — a named range on that trace
  (``torch.profiler.record_function``);
* :class:`StepTimer` — per-step wall time on the host clock, synchronised
  with the card when it is given one (the per-frame trainer's ``Time``).
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(logdir: str, device: torch.device | str = "cpu"):
    """Profile the block; on exit write ``<logdir>/trace_<pid>.json``.
    Yields the ``torch.profiler.profile``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(logdir, f"trace_{os.getpid()}.json"))


def annotate(name: str):
    return torch.profiler.record_function(name)


class StepTimer:
    """Accumulates per-step wall time; ``stop`` waits for ``device`` (a
    card) before it reads the clock."""

    def __init__(self, device: torch.device | str = "cpu"):
        self.sync = torch.device(device).type == "cuda"
        self.times: list[float] = []
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def elapsed(self) -> float:
        """Seconds since :meth:`start`, not recorded and not synchronised."""
        return time.perf_counter() - self._t0

    def stop(self) -> float:
        if self.sync:
            torch.cuda.synchronize()
        dt = self.elapsed()
        self.times.append(dt)
        return dt

    def mean(self) -> float:
        return sum(self.times) / max(len(self.times), 1)
