"""Profiling hooks: `torch.profiler` traces of the frame pipeline.

Counterpart of `splat_renderer_tpu/utils/profiling.py`.  Usage:

    with trace("/tmp/splat-trace"):
        with annotate("frame"):
            engine.frame(camera, generator)
    # then open /tmp/splat-trace/trace.json in chrome://tracing or Perfetto
"""

from __future__ import annotations

import contextlib
import os

import torch
from torch.profiler import ProfilerActivity, profile, record_function

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block's host work and, where torch sees a CUDA device,
    its kernels; on exit write a Chrome trace to `log_dir`/trace.json.
    Yields the profiler (its `key_averages()` sums time by op)."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def annotate(name: str):
    """Named trace span for host-side phases."""
    return record_function(name)
