"""Profiling and tracing utilities (tracerboy_tpu/utils/profiling.py).

The observability analog of the reference's PIX markers and stats
readback (SURVEY.md 5.1: PIXScopedEvent around every pass, UI ms/frame
counters), on torch.profiler:

- `scope(name)`: a torch.profiler.record_function range, so a pass shows
  up named in a trace (the JAX package's jax.named_scope).
- `trace_to(dir)`: a torch.profiler.profile around the block, with CUDA
  activity where the device has it, written into dir as a Chrome trace
  (open it in Perfetto or chrome://tracing).
- `FrameStats`: rolling per-pass wall-clock stats (ms/frame, rays/s,
  live-lane fraction), the UIController counter panel's data source; a
  copy of the JAX class.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict, deque


@contextlib.contextmanager
def scope(name: str):
    """A named range in torch.profiler traces."""
    import torch

    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def trace_to(log_dir: str):
    """Profile the block (CPU, and CUDA where available) and write
    log_dir/trace.json, a Chrome trace. Yields the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class FrameStats:
    """Rolling frame statistics (window of `window` frames)."""

    def __init__(self, window: int = 30):
        self.window = window
        self._times = defaultdict(lambda: deque(maxlen=window))
        self._counters = defaultdict(lambda: deque(maxlen=window))

    @contextlib.contextmanager
    def time_pass(self, name: str):
        t0 = time.perf_counter()
        yield
        self._times[name].append(time.perf_counter() - t0)

    def add_counter(self, name: str, value: float):
        self._counters[name].append(float(value))

    def mean_ms(self, name: str) -> float:
        d = self._times.get(name)
        return 1000.0 * sum(d) / len(d) if d else 0.0

    def mean_counter(self, name: str) -> float:
        d = self._counters.get(name)
        return sum(d) / len(d) if d else 0.0

    def summary(self) -> str:
        parts = [
            f"{k}: {self.mean_ms(k):.1f}ms" for k in sorted(self._times)
        ]
        parts += [
            f"{k}: {self.mean_counter(k):.3g}" for k in sorted(self._counters)
        ]
        return " | ".join(parts)
