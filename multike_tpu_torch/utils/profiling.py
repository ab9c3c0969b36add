"""Tracing and timing helpers (counterpart of multike_tpu/utils/profiling.py).

  * ``trace(dir)``: a context manager around ``torch.profiler`` (host and,
    where there is a card, CUDA activity) that writes a Chrome trace,
    ``trace.json``, into ``dir``;
  * ``StepTimer``: named wall-clock totals, printed on demand. A region that
    launches device work should end in a synchronize, or it times only the
    launches.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator

import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def measure(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> str:
        lines = []
        for name in sorted(self.totals):
            n = self.counts[name]
            tot = self.totals[name]
            lines.append(f"{name}: total {tot:.3f}s over {n} calls "
                         f"(avg {tot / max(n, 1) * 1e3:.2f} ms)")
        return "\n".join(lines)
