"""The traced run's profiler stretches and what the metric readers read.

A traced run times the benchmark's spans (`spans.Spans`, CUDA events) over
its whole window, then profiles two stretches of a fixed number of frames
or steps each:

- the device stretch: `torch.profiler` with the device's activity alone
  and the spans off, so no host-side profiling stretches a frame.  It gives
  the busy time (the union of the device's operations), the length of the
  stretch on the host's clock from its first item's start to its last
  item's end, the heaviest operations and each kernel's times.  The idle
  share holds its busy time an item against the window's unprofiled
  items, since tracing each launch still slows the host;
- the host stretch: the profiler with the host's activity as well and the
  spans named, which only files the device's idle gaps under the span the
  host was in (the breakdown); the profiler's own host cost is in them.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

import torch

from . import timeline
from .spans import Spans

ITEM = "gpubench/item"


def seed_of(seed: int, *parts: int) -> int:
    """A 63-bit generator seed from the run's seed and a position (frame,
    step or purpose), the same on every device."""
    x = seed & (2**64 - 1)
    for p in parts:
        x = (x * 6364136223846793005 + (p & (2**64 - 1)) * 1442695040888963407 + 1) % 2**64
        x ^= x >> 29
    return x % 2**63


class Stretch:
    """`torch.profiler` over a stretch of items (a `with` block, each item
    inside `item()`); `host` adds the host's activity and the item spans."""

    def __init__(self, device: torch.device, host: bool):
        from torch.profiler import ProfilerActivity, profile

        self.host = host or device.type != "cuda"
        acts = [ProfilerActivity.CUDA] if device.type == "cuda" else []
        if self.host:
            acts.append(ProfilerActivity.CPU)
        self._prof = profile(activities=acts)
        self.items: List[Tuple[float, float]] = []  # host seconds

    def __enter__(self):
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        self._prof.__exit__(*exc)
        return False

    @contextmanager
    def item(self):
        t0 = time.perf_counter()
        if self.host:
            with torch.profiler.record_function(ITEM):
                yield
        else:
            yield
        self.items.append((t0, time.perf_counter()))

    def summary(self) -> "Timeline":
        """The stretch's timeline; the profiler's events are read here, after
        the window, not when the stretch ends."""
        spans, device, host = [], [], []
        for e in self._prof.events():
            r = (e.time_range.start, e.time_range.end)
            if e.name.startswith("gpubench/") and e.device_type != torch.autograd.DeviceType.CPU:
                continue  # a span's mirror on the device's timeline, not an operation
            if e.device_type == torch.autograd.DeviceType.CUDA:
                device.append((r[0], r[1], e.name))
            elif e.name == ITEM:
                spans.append(r)
            elif e.name.startswith("gpubench/"):
                host.append((r[0], r[1], e.name[len("gpubench/"):]))
        return Timeline(self.items, device, sorted(spans), host)


class Timeline:
    """`items` in host seconds; the device's operations and the spans in
    microseconds of the profiler's clock.  The profiler ran over the items
    alone, so every device operation it holds belongs to them."""

    def __init__(self, items, device, item_spans, host):
        self.items = items
        self.device = device
        self.item_spans = item_spans
        self.host = host

    def busy_s(self) -> float:
        return timeline.busy([(a, b) for a, b, _ in self.device], -float("inf"),
                             float("inf")) / 1e6

    def window_s(self) -> float:
        return self.items[-1][1] - self.items[0][0] if self.items else 0.0

    def kernel_s(self, substring: str, n: int) -> float:
        """Device seconds of the first n launches, in time order, of the
        kernel whose name holds `substring`: one a frame or step, so those
        of the stretch's first n frames or steps."""
        runs = sorted((s, e) for s, e, name in self.device if substring in name)
        return sum(e - s for s, e in runs[:n]) / 1e6

    def device_ops(self) -> List[List]:
        return timeline.top_by_name((n[:120], (e - s) / 1e6) for s, e, n in self.device)

    def idle_gaps(self) -> List[List]:
        """The device's idle gaps inside the item spans, by the innermost
        harness span the host was in (a host stretch's timeline)."""
        if not self.item_spans:
            return []
        lo, hi = self.item_spans[0][0], self.item_spans[-1][1]
        gaps = timeline.gap_causes([(s, e) for s, e, _ in self.device], self.host, lo, hi)
        return [[n, v / 1e6] for n, v in gaps]


class TracedRun:
    """What a metric reader gets: the spans of the window, the device
    stretch's timeline (and the host stretch's), and the driver's roofline
    hook."""

    def __init__(self, spans: Spans, line: Timeline, host_line: Optional[Timeline] = None,
                 roofline=None, item_s: Optional[float] = None):
        self.spans = spans
        self.timeline = line
        self.host_timeline = host_line
        self._roofline = roofline
        self.item_s = item_s  # an unprofiled item's mean host seconds

    def breakdown(self) -> dict:
        return {"device_ops": self.timeline.device_ops(),
                "idle_gaps": self.host_timeline.idle_gaps() if self.host_timeline else []}

    def span_ms(self, name: str) -> Optional[float]:
        return self.spans.mean_ms(name)

    def idle_percent(self) -> Optional[float]:
        """The share of an unprofiled item's time in which the device is
        idle: 1 - the device stretch's busy time an item over the mean time
        of the window's unprofiled items.  Profiling the device's activity
        slows each launch on the host; the kernels it times are not slowed,
        so the busy time is read there and the item's length off the
        profiler."""
        n = len(self.timeline.items)
        if not n or not self.item_s or not self.timeline.device:
            return None
        return 100.0 * (1.0 - self.timeline.busy_s() / n / self.item_s)

    def roofline(self, ops: str, kernel: str, items: int) -> Optional[float]:
        if self._roofline is None:
            return None
        return self._roofline(ops, kernel, items)


def read_metrics(readers: Dict[str, object], run: TracedRun) -> Dict[str, float]:
    out = {}
    for name, mod in readers.items():
        v = mod.read(run)
        if v is not None:
            out[name] = float(v)
    return out


def wrap_targets(readers: Dict[str, object]) -> Dict[str, str]:
    """Span name -> program entry, from every reader's WRAP."""
    out = {}
    for mod in readers.values():
        out.update(getattr(mod, "WRAP", {}))
    return out
