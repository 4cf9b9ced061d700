"""Named accumulating timers (counterpart of mjmpc_tpu/utils/timer.py).

CUDA work is asynchronous, so a span's stop synchronises the device (when
CUDA is in use) before it reads the clock: a span then covers the device
work its host code queued. This is the coarse percent-of-total report the
harness prints; kernel times come from CUDA events (chip_smoke.py).
"""
from __future__ import annotations

import time
from typing import Dict

import torch


class TimeIt:
    def __init__(self):
        self._starts: Dict[str, float] = {}
        self.elapsed: Dict[str, float] = {}

    def start(self, name: str):
        self._starts[name] = time.perf_counter()

    def stop(self, name: str):
        if name not in self._starts:
            raise KeyError(f"timer {name!r} was never started")
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        dt = time.perf_counter() - self._starts.pop(name)
        self.elapsed[name] = self.elapsed.get(name, 0.0) + dt
        return dt

    def reset(self):
        self._starts.clear()
        self.elapsed.clear()

    def report(self) -> str:
        total = sum(self.elapsed.values()) or 1.0
        lines = [f"{k}: {v:.4f}s ({100.0 * v / total:.1f}%)"
                 for k, v in sorted(self.elapsed.items())]
        return "\n".join(lines)

    def __str__(self):
        return self.report()


timeit = TimeIt()  # module singleton, like the reference's
