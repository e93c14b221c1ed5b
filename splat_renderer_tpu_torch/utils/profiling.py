"""The port's recorder: spans at the layer edges, counters, and
`torch.profiler` traces.

Counterpart of `splat_renderer_tpu/utils/profiling.py`.  The program opens
a `span` at every layer edge (`frame`, `model/descent`, `fit/backward`,
...) and counts the pairs each binning makes (`count("pairs", ...)`).
Tracing is off by default: a span is then its name's one shared null
context, handed back after a single flag check, and records nothing,
launches nothing and waits for nothing.  Turned on (`enable()`, or scoped: `recording()`), each
span records its name, its parent and its host start and end
(`time.perf_counter_ns`), and on a CUDA device a CUDA event pair on the
current stream; on a CPU device a span's device time is its host time.
Records stay in memory until they are read, once, at the end:

    enable()
    ...                       # frames or fit steps
    report()["frame"]         # calls, device and host ms, self ms
    counter("pairs", within="frame")

`trace(log_dir)` records too, and only there does a span also open
`record_function("splat/<name>")`, so the Chrome trace it writes shows the
layers on the kernels' own timeline:

    with trace("/tmp/splat-trace"):
        engine.frame(camera, generator)
    # then open /tmp/splat-trace/trace.json in chrome://tracing or Perfetto
"""

from __future__ import annotations

import contextlib
import functools
import os
import statistics
import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple

import torch
from torch.profiler import ProfilerActivity, profile, record_function

TRACE_FILE = "trace.json"
RANGE_PREFIX = "splat/"

# a call: [name, parent call's index or -1, host start ns, host end ns (0
# while open), entry event, exit event]
_NAME, _PARENT, _T0, _T1, _EV0, _EV1 = range(6)


class Recorder:
    """The spans and counters recorded while tracing is on; where torch
    sees a CUDA device, each span is timed by a CUDA event pair as well."""

    def __init__(self):
        self.cuda = torch.cuda.is_available()
        self.calls: List[list] = []
        self.counts: Dict[Tuple[str, Optional[str]], torch.Tensor] = {}
        self._local = threading.local()  # each thread's stack of open calls

    def stack(self) -> List[int]:
        s = getattr(self._local, "stack", None)
        if s is None:
            s = self._local.stack = []
        return s

    def count(self, name: str, value: torch.Tensor) -> None:
        """Add `value` (a 0-dim tensor) into the accumulator of `name` under
        the outermost span open in this thread, on the value's device."""
        stack = self.stack()
        key = (name, self.calls[stack[0]][_NAME] if stack else None)
        acc = self.counts.get(key)
        v = value.detach()
        if acc is None:
            dtype = torch.float64 if v.is_floating_point() else torch.int64
            self.counts[key] = v.to(dtype).clone()
        else:
            acc.add_(v)

    def counter(self, name: str, within: Optional[str] = None) -> float:
        """The total of `name`: every count, or only those made while the
        outermost open span was `within`."""
        return float(sum(int(v) if not v.is_floating_point() else float(v)
                         for (n, root), v in self.counts.items()
                         if n == name and (within is None or root == within)))

    def _closed(self) -> List[int]:
        return [i for i, c in enumerate(self.calls) if c[_T1]]

    def _device_ms(self, idx: List[int]) -> Dict[int, float]:
        if self.cuda and idx:
            torch.cuda.synchronize()
            return {i: self.calls[i][_EV0].elapsed_time(self.calls[i][_EV1]) for i in idx}
        return {i: (self.calls[i][_T1] - self.calls[i][_T0]) / 1e6 for i in idx}

    def device_ms(self, name: str) -> List[float]:
        """Each closed call's device ms of `name`, in call order."""
        idx = [i for i in self._closed() if self.calls[i][_NAME] == name]
        dev = self._device_ms(idx)
        return [dev[i] for i in idx]

    def report(self) -> Dict[str, Dict[str, float]]:
        """Per span name: its calls, the median and mean device ms, the
        median host ms, and the median self ms (device ms less its
        children's)."""
        idx = self._closed()
        dev = self._device_ms(idx)
        children = dict.fromkeys(idx, 0.0)
        for i in idx:
            p = self.calls[i][_PARENT]
            if p in children:
                children[p] += dev[i]
        by_name: Dict[str, List[int]] = {}
        for i in idx:
            by_name.setdefault(self.calls[i][_NAME], []).append(i)
        out = {}
        for name, ii in by_name.items():
            d = [dev[i] for i in ii]
            out[name] = {
                "calls": len(ii),
                "device_ms_median": statistics.median(d),
                "device_ms_mean": statistics.fmean(d),
                "host_ms_median": statistics.median(
                    (self.calls[i][_T1] - self.calls[i][_T0]) / 1e6 for i in ii),
                "self_ms": statistics.median(dev[i] - children[i] for i in ii),
            }
        return out

    def intervals(self) -> List[Tuple[str, Optional[str], float, float]]:
        """Each closed call's (name, parent's name or None, host start,
        host end), in `time.perf_counter` seconds, in call order."""
        out = []
        for i in self._closed():
            name, p, t0, t1 = self.calls[i][:4]
            out.append((name, self.calls[p][_NAME] if p >= 0 else None, t0 / 1e9, t1 / 1e9))
        return out


def _decorate(self, fn):
    name = self.name

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with span(name):
            return fn(*args, **kwargs)

    return wrapper


class _Null:
    """A span while tracing is off: enters and leaves doing nothing."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    __call__ = _decorate


class _Span:
    __slots__ = ("name", "rec", "index", "range")

    def __init__(self, rec: Recorder, name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        rec = self.rec
        stack = rec.stack()
        call = [self.name, stack[-1] if stack else -1, time.perf_counter_ns(), 0, None, None]
        if rec.cuda:
            call[_EV0] = torch.cuda.Event(enable_timing=True)
            call[_EV0].record()
        self.range = record_function(RANGE_PREFIX + self.name) if _ranges else None
        if self.range is not None:
            self.range.__enter__()
        self.index = len(rec.calls)
        rec.calls.append(call)
        stack.append(self.index)
        return self

    def __exit__(self, *exc):
        rec = self.rec
        call = rec.calls[self.index]
        if self.range is not None:
            self.range.__exit__(*exc)
        if rec.cuda:
            call[_EV1] = torch.cuda.Event(enable_timing=True)
            call[_EV1].record()
        call[_T1] = time.perf_counter_ns()
        rec.stack().pop()
        return False

    __call__ = _decorate


_on = False
_ranges = False  # spans open profiler ranges (inside `trace` only)
_recorder = Recorder()
_nulls: Dict[str, _Null] = {}


def span(name: str):
    """A context manager (and decorator) marking a layer's work as `name`.
    Off: the name's shared null context."""
    if not _on:
        null = _nulls.get(name)
        if null is None:
            null = _nulls[name] = _Null(name)
        return null
    return _Span(_recorder, name)


def enabled() -> bool:
    """Whether tracing is on: call sites guard `count` with it, so the
    counted value is not even computed while it is off."""
    return _on


def count(name: str, value: torch.Tensor) -> None:
    """Add a 0-dim tensor into the device accumulator of `name`, without
    reading it back; nothing while tracing is off."""
    if _on:
        _recorder.count(name, value)


def enable() -> None:
    """Turn tracing on."""
    global _on
    _on = True


def disable() -> None:
    """Turn tracing off; what was recorded stays readable."""
    global _on
    _on = False


def reset() -> None:
    """Drop every record and count."""
    global _recorder
    _recorder = Recorder()


@contextlib.contextmanager
def recording() -> Iterator[Recorder]:
    """Record the block's spans into a recorder of its own (yielded), and
    leave tracing as it found it: on or off, with its records."""
    global _on, _recorder
    saved = _on, _recorder
    _recorder = Recorder()
    _on = True
    try:
        yield _recorder
    finally:
        _on, _recorder = saved


def report() -> Dict[str, Dict[str, float]]:
    """`Recorder.report` of the global recorder."""
    return _recorder.report()


def intervals() -> List[Tuple[str, Optional[str], float, float]]:
    """`Recorder.intervals` of the global recorder."""
    return _recorder.intervals()


def counter(name: str, within: Optional[str] = None) -> float:
    """`Recorder.counter` of the global recorder."""
    return _recorder.counter(name, within)


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block's host work and, where torch sees a CUDA device,
    its kernels, with tracing on and every span also a profiler range
    "splat/<name>"; on exit write a Chrome trace to `log_dir`/trace.json.
    Yields the profiler (its `key_averages()` sums time by op)."""
    global _ranges
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    saved = _ranges
    with recording(), profile(activities=activities) as prof:
        _ranges = True
        try:
            yield prof
        finally:
            _ranges = saved
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))
