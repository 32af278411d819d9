"""Frame profiler (counterpart of clap_tpu/utils/profiler.py;
reference: core/profiler.{c,h} PROF_FIRST/PROF_STEP).

The reference chains CLOCK_MONOTONIC timestamps per frame segment
(move/phys/net/updates/callback/scene_render/ui_render, clap.c:581-650)
with ring-buffer plots. The port queues each frame's kernels on the
card asynchronously, so host-side segment timing covers the dispatch rim
(host dispatch time, not device time); device-side detail comes from
torch.profiler traces. This module provides:

- ``Profiler``: PROF_STEP-style named segments + per-segment ring
  buffers (plot-ready) + FPS accounting (clap_fps_calc analogue,
  clap.c:224-258).
- ``trace``: context manager around torch.profiler for deep dives.
"""
from __future__ import annotations

import contextlib
import time
from collections import deque


class Profiler:
    def __init__(self, window: int = 120):
        self.window = window
        self.segments: dict[str, deque] = {}
        self._t0 = None
        self._last = None
        self.frame_times = deque(maxlen=window)
        self._frame_start = None

    # PROF_FIRST (profiler.h:35-44)
    def frame_begin(self):
        self._frame_start = self._last = time.perf_counter()

    # PROF_STEP
    def step(self, name: str):
        now = time.perf_counter()
        seg = self.segments.setdefault(name, deque(maxlen=self.window))
        seg.append(now - self._last)
        self._last = now

    def frame_end(self):
        now = time.perf_counter()
        self.frame_times.append(now - self._frame_start)

    @property
    def fps(self) -> float:
        if not self.frame_times:
            return 0.0
        return len(self.frame_times) / max(sum(self.frame_times), 1e-9)

    def report(self) -> dict:
        out = {"fps": round(self.fps, 1)}
        for name, seg in self.segments.items():
            if seg:
                out[name + "_ms"] = round(sum(seg) / len(seg) * 1e3, 3)
        return out


@contextlib.contextmanager
def trace(logdir: str):
    """Device-side profiling via torch.profiler (the deep-dive analogue of
    the reference's renderer_debug counters): host and, where a CUDA card
    is present, device activity of the block, written as a Chrome trace to
    ``logdir``/trace.json. Yields the profile."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
