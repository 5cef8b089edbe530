"""Profiling & metrics — parity with the reference's observability
(SURVEY §5.1): cudaEvent kernel timing + the editor's Developer Metrics
panel (`Renderer.cu:97-108`, `EditorLayer.cpp:100-165`):

- `DeviceTimer`: wall-clock around `block_until_ready` (the XLA analog
  of paired cudaEvents).
- `FrameStats`: running min/avg/max render rate, like the editor panel.
- `trace()`: context manager around `jax.profiler` emitting a TensorBoard
  trace directory for op-level analysis (the Nsight stand-in).
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import jax


class DeviceTimer:
    """Times jitted steps end-to-end (dispatch + device execution)."""

    def __init__(self):
        self.ms = 0.0
        self.calls = 0
        self.total_ms = 0.0

    @contextlib.contextmanager
    def time(self, result_getter=None):
        t0 = time.perf_counter()
        holder = {}
        try:
            yield holder
        finally:
            if "result" in holder:
                jax.block_until_ready(holder["result"])
            self.ms = (time.perf_counter() - t0) * 1e3
            self.total_ms += self.ms
            self.calls += 1

    @property
    def avg_ms(self):
        return self.total_ms / max(self.calls, 1)


@dataclass
class FrameStats:
    """min/avg/max frequency tracker (`EditorLayer.cpp:135-163`)."""

    min_ms: float = float("inf")
    max_ms: float = 0.0
    total_ms: float = 0.0
    frames: int = 0
    _last: float = field(default=0.0, repr=False)

    def begin(self):
        self._last = time.perf_counter()

    def end(self):
        ms = (time.perf_counter() - self._last) * 1e3
        self.min_ms = min(self.min_ms, ms)
        self.max_ms = max(self.max_ms, ms)
        self.total_ms += ms
        self.frames += 1
        return ms

    @property
    def avg_ms(self):
        return self.total_ms / max(self.frames, 1)

    def report(self) -> dict:
        avg = self.avg_ms
        return {
            "frames": self.frames,
            "ms_min": round(self.min_ms, 3) if self.frames else None,
            "ms_avg": round(avg, 3),
            "ms_max": round(self.max_ms, 3),
            "hz_max": round(1000.0 / self.min_ms, 2) if self.frames else None,
            "hz_avg": round(1000.0 / avg, 2) if avg else None,
            "hz_min": round(1000.0 / self.max_ms, 2) if self.max_ms else None,
        }


@contextlib.contextmanager
def trace(log_dir: str = "/tmp/drt_trace"):
    """jax.profiler trace (view in TensorBoard / xprof)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def estimate_rays(width: int, height: int, spp: int, bounces: int,
                  sun_enabled: bool = True) -> int:
    """Upper-bound traced-ray count for throughput metrics: path segments
    plus one shadow ray per bounce when sun NEE is on."""
    per_path = bounces * (2 if sun_enabled else 1)
    return width * height * spp * per_path
